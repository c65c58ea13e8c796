"""Slot-batched serving engine (counterpart of
timeviper_tpu/serving/engine.py): continuous batching of many requests over
one model on one card.

A hybrid Mamba model needs no paged KV: a sequence's state is O(1) in its
Mamba layers (conv window and SSM state) plus fixed-capacity K/V buffers in
its few attention layers. So the engine holds `num_slots` sequence states in
one batched decode cache, and each round

  0. advances the one long prompt in flight by one chunk, when
     `prefill_chunk_tokens` is set (the chunked-prefill analog: a long prompt
     stalls the decode streams by one chunk a round, not by its whole
     prefill); its chunks run through the continuation,
     models/prefix_cache.py:nano_forward_continue, from an empty cache;
  1. prefills queued requests into the free slots: text-only prompts of one
     length bucket as one `nano_forward` of batch B (power-of-two groups,
     each row with its own left pad), a request with pixels alone through the
     Generator's bucketed prefill, a request on a cached prefix
     (`prefill_prefix`) through the continuation on that prefix's cache;
  2. runs `steps_per_sync` decode steps of all slots at once (each slot at
     its own length: models/nano.py:nano_decode_step with one length and
     valid_from per row), then syncs the host once and trims the slots that
     met a terminator or their token budget;
  3. copies each new prefill's state into its slot's rows of the batched
     cache, in place: the prefill's K/V rows up to its length and its Mamba
     states (the decode writes each later row before it reads it, so the
     rows past a slot's length need no clearing).

Per-request rejections (a prompt whose bucket and token budget overflow
`max_len`, the prefix requests' checks) land in `Request.error`, with the
JAX engine's messages, and the other requests go on.

Where the port leaves the JAX engine behind, and why:

* One stream, in order. JAX dispatches the prefills and the decode burst
  asynchronously and scatters the prefilled states into the post-burst cache
  as device ops; the port runs the same schedule eagerly on one stream. The
  results are the same.
* The decode runs the slots as a batch dimension with a per-row key mask,
  where JAX vmaps a batch-1 step over them; a free slot decodes at length 0
  (its rows are overwritten by the next insert), where JAX lets it run on at
  its stale length.
* Continuations take the real rows only (no trailing pads), and a prefill
  fills a cache of its own bucket's capacity, copied into the slot.
* `Request.first_logits` keeps the f32 logits of the prompt's last row, the
  first token's distribution.
* A fault of the JAX engine is not copied: in the round where a chunked
  prompt completes, JAX lists its slot as free again before inserting its
  state, so a queued request can be given the same slot and is then lost.

pdrop serving (`pdrop_frames`, timeviper_tpu/serving/engine.py:131-175,
:328-365, :480-535): a request with pixels must bring exactly
`pdrop_frames` frames and runs the Generator's bucketed pdrop prefill; its
compacted state goes into the slot with each attention layer's row count
`kv_len` (a layer before a stage keeps the pre-drop rows, so the capacity
check is against the pre-drop bucket) and each stage's TransV K/V, sized
once by the stages' drop counts at that frame budget. Every other request
gets zero TransV rows, which cross-attention turns into exactly 0 (the
model has no attention biases). The port keeps each attention layer's
`kv_len` per slot on the host, as it keeps the lengths, and builds the (B,)
tensors for each step. A pdrop prefix state is refused in a slot, as in the
JAX engine.

Not ported yet: sequence-parallel serving (`mesh`, ROADMAP Queue 1 item 8),
which raises NotImplementedError; without a mesh the JAX engine's
`batch_prefill` switch has no use, and text prompts always prefill in
batches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from timeviper_tpu_torch.models.generate import Generator, PrefixState, _fused_conv_default
from timeviper_tpu_torch.models.nano import nano_forward
from timeviper_tpu_torch.models.pdrop import pdrop_drop_counts
from timeviper_tpu_torch.models.prefix_cache import nano_forward_continue
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, decode_step, init_cache
from timeviper_tpu_torch.ops.sampling import SamplingParams, sample_token


@dataclasses.dataclass
class Request:
    request_id: int
    input_ids: List[int]
    pixels: Optional[Any] = None  # (F, H, W, 3) frames, a tensor or an array
    image_token_id: int = -1
    max_new_tokens: int = 128
    # a question on a cached video prefix (engine.prefill_prefix): input_ids
    # is then the question suffix only
    prefix: Optional[PrefixState] = None
    # filled by the engine
    output_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    first_logits: Optional[torch.Tensor] = None  # (1, V) f32, the prompt's last row


def _copy_state(dst_layers, slot: int, src_layers, row: int, n: int) -> None:
    """Copy row `row` of a prefill's cache (its first n K/V rows, or a
    layer's own `kv_len`, and its Mamba states) into slot `slot` of the
    batched cache, in place."""
    for dl, sl in zip(dst_layers, src_layers):
        if "k" in sl:
            rows = sl.get("kv_len", n)
            dl["k"][slot, :rows].copy_(sl["k"][row, :rows])
            dl["v"][slot, :rows].copy_(sl["v"][row, :rows])
        if "ssm_state" in sl:
            dl["ssm_state"][slot].copy_(sl["ssm_state"][row])
            for role, window in sl["conv_state"].items():
                dl["conv_state"][role][slot].copy_(window[row])


class ServingEngine:
    def __init__(
        self,
        model: TimeViperVLM,
        arch: VLMArch,
        *,
        terminator_ids: Sequence[int],
        num_slots: int = 8,
        max_len: int = 32768,
        max_new_tokens: int = 128,
        sampling: SamplingParams = SamplingParams(),
        pad_token_id: int = 0,
        cache_dtype=torch.bfloat16,
        steps_per_sync: int = 4,
        mesh=None,
        prefill_chunk_tokens: Optional[int] = None,
        pdrop_frames: Optional[int] = None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError("sequence-parallel serving (mesh=) is not ported "
                                      "(ROADMAP Queue 1 item 8)")
        self.model = model
        self.arch = arch
        self.num_slots = num_slots
        self.max_len = max_len
        self.sampling = sampling
        self.terminators = tuple(int(t) for t in terminator_ids)
        chunk = arch.llm.chunk_size
        if prefill_chunk_tokens is not None:  # rounded up to whole SSD chunks
            prefill_chunk_tokens = -(-prefill_chunk_tokens // chunk) * chunk
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.cache_dtype = cache_dtype
        self._chunked: Optional[Dict[str, Any]] = None
        self._gen = Generator(model, arch, terminator_ids=terminator_ids,
                              pad_token_id=pad_token_id, max_new_tokens=max_new_tokens,
                              sampling=sampling)
        self.device = self._gen.device
        self.cache_layers = init_cache(arch, num_slots, max_len, cache_dtype,
                                       device=self.device)["layers"]
        self._pdrop = None if pdrop_frames is None else self._init_pdrop(pdrop_frames)
        # per-slot host state
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slot_lengths = np.zeros((num_slots,), np.int64)
        self.slot_valid_from = np.zeros((num_slots,), np.int64)
        self.queue: List[Request] = []
        self._last_tokens = np.zeros((num_slots,), np.int64)
        # decode steps per host sync: slots that meet a terminator mid-burst
        # are trimmed on the host
        self.steps_per_sync = max(1, steps_per_sync)
        self.round_stamps: List[float] = []

    def _init_pdrop(self, frames: int) -> Dict[str, Any]:
        """The pdrop state: the visual tokens a request brings, each stage's
        slot-batched TransV K/V buffers ({} for a stage that merges
        nothing) and each attention layer's kv_len per slot (host)."""
        llm = self.arch.llm
        if not (llm.use_pdrop and llm.pdrop_stages):
            raise ValueError("pdrop_frames requires a pdrop-configured llm")
        if any(st.layer >= llm.num_hidden_layers for st in llm.pdrop_stages):
            raise ValueError("a pdrop stage beyond the layer stack never fires, but its drop "
                             "count would corrupt the host's length tracking")
        if llm.attention_bias:
            raise ValueError("pdrop serving relies on zero TransV rows being exactly inert "
                             "for the other slots (no attention biases)")
        nv = frames * self.arch.tokens_per_frame
        drops = pdrop_drop_counts(llm, nv)
        merge = self.model.merge_modules
        shape = (self.num_slots, llm.num_key_value_heads, llm.head_dim)
        ca = [{key: torch.zeros(shape[0], drop, *shape[1:], dtype=self.cache_dtype,
                                device=self.device) for key in ("k", "v")}
              if merge is not None and merge.stage(si) is not None and drop > 0 else {}
              for si, drop in enumerate(drops)]
        return {"frames": frames, "num_visual": nv, "ca_kv": ca,
                "kv_len": {i: np.zeros((self.num_slots,), np.int64)
                           for i, bt in enumerate(llm.layers_block_type) if bt == "attention"}}

    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def prefill_prefix(self, input_ids, pixels=None, image_token_id=-1,
                       suffix_budget: int = 512) -> PrefixState:
        """Prefill a shared `system + <video>` prefix once for this engine;
        the returned PrefixState serves any number of Requests
        (prefix=state, input_ids=the question). Its cache has the engine's
        capacity."""
        return self._gen.prefill_prefix(input_ids, pixels=pixels, image_token_id=image_token_id,
                                        suffix_budget=suffix_budget, cache_len=self.max_len)

    def _first_token(self, logits: torch.Tensor, req: Request) -> torch.Tensor:
        gen = None
        if self.sampling.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(req.request_id)
        return sample_token(logits, gen, self.sampling)

    def _pending(self, req: Request, slot: int, logits, cache1, bucket: int, pad: int,
                 row: int = 0) -> Dict[str, Any]:
        return {"req": req, "slot": slot, "logits": logits[row:row + 1],
                "first_tok": self._first_token(logits[row:row + 1], req), "cache1": cache1,
                "row": row, "bucket": bucket, "pad": pad}

    @torch.inference_mode()
    def _dispatch_continue(self, req: Request, slot: int) -> Dict[str, Any]:
        """Run the question suffix on its cached video prefix
        (models/prefix_cache.py) for insertion into a slot. The JAX engine's
        ValueErrors."""
        st = req.prefix
        if st.cache.get("ca_kv") is not None:
            raise ValueError(
                f"request {req.request_id}: pdrop prefix states are not"
                " servable — dropping compacts the cache so its true row"
                " count lives on device, but engine slots track lengths"
                " host-side (use the offline Generator for pdrop)")
        if st.cache_len != self.max_len:
            raise ValueError(
                f"request {req.request_id}: prefix cache_len {st.cache_len}"
                f" != engine max_len {self.max_len} — build the prefix via"
                " engine.prefill_prefix")
        ids = list(req.input_ids)
        if req.pixels is not None or req.image_token_id in ids:
            raise ValueError(
                f"request {req.request_id}: prefix requests are text-only"
                " (the video lives in the prefix cache) — dropping frames"
                " silently would return plausible-but-wrong output")
        if not ids:
            raise ValueError(
                f"request {req.request_id}: empty suffix on a cached"
                " prefix")
        chunk = self.arch.llm.chunk_size
        sb = max(chunk, -(-len(ids) // chunk) * chunk)
        if sb > st.suffix_budget:
            raise ValueError(
                f"request {req.request_id}: suffix of {len(ids)} tokens"
                f" needs a {sb}-token bucket (chunk multiple) > the"
                f" prefix's suffix_budget {st.suffix_budget}")
        total = st.bucket + len(ids)
        if total + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.request_id}: prefix {st.bucket} + suffix"
                f" {len(ids)} + max_new_tokens {req.max_new_tokens}"
                f" exceeds engine max_len {self.max_len}")
        llm = self.model.llm_backbone
        embeds = llm.embeddings(torch.as_tensor([ids], dtype=torch.long, device=self.device))
        logits, cache1 = nano_forward_continue(llm, self.arch.llm, embeds, st.cache)
        return self._pending(req, slot, logits, cache1, total, st.pad)

    def _free_slots(self) -> List[int]:
        held = self._chunked["slot"] if self._chunked else -1
        return [i for i, r in enumerate(self.slot_req) if r is None and i != held]

    def _start_chunked(self, req: Request, slot: int) -> None:
        """Begin a chunked prefill: reserve `slot` and an empty one-row cache
        of the prompt's length; _advance_chunked moves it one chunk a round."""
        self._chunked = {
            "req": req, "slot": slot, "ids": list(req.input_ids), "pos": 0,
            "cache": init_cache(self.arch, 1, len(req.input_ids), self.cache_dtype,
                                device=self.device),
        }

    @torch.inference_mode()
    def _advance_chunked(self) -> Optional[Dict[str, Any]]:
        """Run ONE chunk of the long prompt in flight. Returns a pending
        record when the prompt is complete, else None."""
        st = self._chunked
        ids, pos = st["ids"], st["pos"]
        n = min(self.prefill_chunk_tokens, len(ids) - pos)
        llm = self.model.llm_backbone
        embeds = llm.embeddings(torch.as_tensor([ids[pos:pos + n]], dtype=torch.long,
                                                device=self.device))
        logits, st["cache"] = nano_forward_continue(llm, self.arch.llm, embeds, st["cache"])
        st["pos"] = pos + n
        if st["pos"] < len(ids):
            return None
        self._chunked = None
        return self._pending(st["req"], st["slot"], logits, st["cache"], len(ids), 0)

    @torch.inference_mode()
    def _dispatch_prefill(self, req: Request, slot: int) -> Dict[str, Any]:
        """One request's bucketed prefill (the Generator's), at a cache of its
        own bucket's capacity; a request with pixels in a pdrop engine runs
        the pdrop prefill, and its slot length is the compacted one."""
        plan, bucket, pad, ids_arr, gather_idx, seq_idx = self._prefill_plan(req)
        pdrop_start = None
        if self._pdrop is not None and req.pixels is not None:
            if plan.num_visual != self._pdrop["num_visual"]:
                raise ValueError(
                    f"request {req.request_id}: pdrop engine is compiled for"
                    f" {self._pdrop['num_visual']} visual tokens"
                    f" ({self._pdrop['frames']} frames); request has"
                    f" {plan.num_visual}")
            pdrop_start = self._gen._pdrop_start(plan, pad, True)
        visual = self._gen.encode_frames(req.pixels) if req.pixels is not None else None
        visual = self._gen._check_visual(plan, visual)
        logits, cache1 = self._gen.prefill(ids_arr, gather_idx, seq_idx, visual, pad, bucket,
                                           pdrop_start)
        return self._pending(req, slot, logits, cache1, cache1["length"], pad)

    def _prefill_plan(self, req: Request):
        """Host-side bucket geometry for one request (the Generator's planner)
        and this engine's capacity check. Returns (plan, bucket, pad, ids_arr,
        gather_idx, seq_idx) or raises ValueError."""
        planned = self._gen._plan_prompt(list(req.input_ids), req.image_token_id)
        bucket = planned[1]
        if bucket + req.max_new_tokens > self.max_len:
            # decode writes K/V at slots [bucket, bucket + max_new) (after a
            # pdrop prefill too: a layer before a stage keeps the pre-drop
            # rows): without headroom the request cannot finish (like vLLM,
            # reject it)
            raise ValueError(
                f"request {req.request_id}: bucket {bucket} + "
                f"max_new_tokens {req.max_new_tokens} exceeds engine "
                f"max_len {self.max_len}"
            )
        return planned

    @torch.inference_mode()
    def _dispatch_prefill_batch(self, group) -> List[Dict[str, Any]]:
        """B text-only prompts of one bucket, [(req, slot, plan), ...], as one
        nano_forward of batch B: each row its own left pad (segment -1),
        which becomes the slot's valid_from on insert. Returns one pending
        record per request."""
        llm = self.model.llm_backbone
        bucket = group[0][2][1]

        def stack(i, dtype):
            return torch.as_tensor(np.stack([plan[i] for _, _, plan in group]), dtype=dtype,
                                   device=self.device)

        emb = llm.embeddings(stack(3, torch.long))
        gather = stack(4, torch.long)
        fused = torch.gather(emb, 1, gather[..., None].expand(-1, -1, emb.shape[-1]))
        pads = [plan[2] for _, _, plan in group]
        out = nano_forward(llm, self.arch.llm, inputs_embeds=fused, seq_idx=stack(5, torch.int32),
                           fill_cache=True, cache_max_len=bucket, logits_to_keep=1,
                           fused_conv=_fused_conv_default())
        logits = out["logits"][:, -1]
        return [self._pending(req, slot, logits, out["cache"], bucket, pad, row)
                for row, ((req, slot, _), pad) in enumerate(zip(group, pads))]

    @torch.inference_mode()
    def _insert_pending(self, pending) -> None:
        """Copy a prefill's state into its slot of the batched cache and
        activate the slot on the host."""
        slot = pending["slot"]
        layers1 = pending["cache1"]["layers"]
        _copy_state(self.cache_layers, slot, layers1, pending["row"], pending["bucket"])
        if self._pdrop is not None:
            for idx, kv_len in self._pdrop["kv_len"].items():
                kv_len[slot] = layers1[idx].get("kv_len", pending["bucket"])
            ca1 = pending["cache1"].get("ca_kv")
            for si, buf in enumerate(self._pdrop["ca_kv"]):
                for key, b in buf.items():
                    if ca1:
                        b[slot].copy_(ca1[si][key])
                    else:  # zeros: exactly inert for a request without TransV rows
                        b[slot].zero_()
        self.slot_req[slot] = pending["req"]
        self.slot_lengths[slot] = pending["bucket"]
        self.slot_valid_from[slot] = pending["pad"]
        self._last_tokens[slot] = 0  # set by _finish_pending

    @torch.inference_mode()
    def _dispatch_decode(self, generator: Optional[torch.Generator]):
        """Run one burst of `steps_per_sync` decode steps over every slot.
        Returns (the burst's tokens (slots, steps) on the device, the active
        slots, their lengths before the burst) or None when no slot is
        active. A free slot decodes at length 0; a slot past its budget
        within the burst writes at the last row (its output is dropped)."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return None
        on = np.zeros((self.num_slots,), np.int64)
        on[active] = 1
        lens = torch.from_numpy(self.slot_lengths * on)
        vf = torch.from_numpy(self.slot_valid_from * on)
        step = torch.from_numpy(on)
        kv_lens = {idx: torch.from_numpy(kv_len * on)
                   for idx, kv_len in (self._pdrop["kv_len"].items() if self._pdrop else ())}
        toks = torch.as_tensor(self._last_tokens, device=self.device)
        burst = []
        for _ in range(self.steps_per_sync):
            layers = [dict(lc, kv_len=kv_lens[idx].clamp(max=self.max_len - 1))
                      if idx in kv_lens else lc for idx, lc in enumerate(self.cache_layers)]
            cache = {"layers": layers,
                     "length": lens.clamp(max=self.max_len - 1), "valid_from": vf}
            if self._pdrop is not None:
                cache["ca_kv"] = self._pdrop["ca_kv"]
            logits, cache = decode_step(self.model, self.arch, toks[:, None], cache)
            # new Mamba states; K/V written in place; kv_len stays on the host
            self.cache_layers = [{k: v for k, v in lc.items() if k != "kv_len"}
                                 for lc in cache["layers"]]
            toks = sample_token(logits, generator, self.sampling)
            burst.append(toks)
            lens = lens + step
            kv_lens = {idx: kv + step for idx, kv in kv_lens.items()}
        return torch.stack(burst, 1), active, self.slot_lengths.copy()

    def _process_burst(self, dispatched) -> None:
        burst, active, lengths = dispatched
        burst = burst.cpu().numpy()  # (slots, steps_per_sync): the sync point
        n = burst.shape[1]
        for i in active:
            req = self.slot_req[i]
            for j in range(n):
                tok = int(burst[i, j])
                req.output_ids.append(tok)
                self.slot_lengths[i] += 1
                self._last_tokens[i] = tok
                if (tok in self.terminators
                        or len(req.output_ids) >= req.max_new_tokens):
                    req.done = True
                    self.slot_req[i] = None
                    break
        for i in active:
            if self.slot_req[i] is not None:
                self.slot_lengths[i] = int(lengths[i]) + n
                for kv_len in (self._pdrop["kv_len"].values() if self._pdrop else ()):
                    kv_len[i] += n

    # ------------------------------------------------------------------

    def _finish_pending(self, pending) -> None:
        """Take a prefill's first token and finalize its slot."""
        req = pending["req"]
        slot = pending["slot"]
        tok = int(pending["first_tok"][0])
        req.first_logits = pending["logits"]
        req.output_ids.append(tok)
        if tok in self.terminators or req.max_new_tokens <= 1:
            req.done = True
            self.slot_req[slot] = None  # the inserted state is abandoned
        else:
            self._last_tokens[slot] = tok

    def run(self, requests: Sequence[Request], rng_seed: int = 0) -> List[Request]:
        """Serve all requests to completion (continuous batching). Each round:
        one chunk of the long prompt in flight, the prefills of queued
        requests into free slots, one decode burst of the active slots, the
        new states into their slots, one host sync. `round_stamps` holds the
        host clock after each round's sync: their gaps are what a decode
        stream waits between bursts, which chunked prefill bounds."""
        for r in requests:
            self.submit(r)
        gen = None
        if self.sampling.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.round_stamps = [time.perf_counter()]
        while (self.queue or self._chunked is not None
               or any(r is not None for r in self.slot_req)):
            pending_chunk = (self._advance_chunked()
                             if self._chunked is not None else None)
            pendings = []
            # a chunked prompt that completed this round still holds its slot
            # until its state is inserted below (the JAX engine hands that
            # slot out again here, and the later insert overwrites the other
            # request's, which then never finishes)
            free = [i for i in self._free_slots()
                    if pending_chunk is None or i != pending_chunk["slot"]]
            taken = []
            while free and self.queue:
                taken.append((self.queue.pop(0), free.pop(0)))
            groups: Dict[int, list] = {}
            singles = []
            requeue = []
            for req, slot in taken:
                if (self.prefill_chunk_tokens
                        and req.prefix is None and req.pixels is None
                        and len(req.input_ids) > self.prefill_chunk_tokens):
                    if (len(req.input_ids) + req.max_new_tokens
                            > self.max_len):
                        req.done = True
                        req.error = (
                            f"request {req.request_id}: prompt "
                            f"{len(req.input_ids)} + max_new_tokens "
                            f"{req.max_new_tokens} exceeds engine "
                            f"max_len {self.max_len}")
                    elif self._chunked is None:
                        self._start_chunked(req, slot)
                    else:  # one long prompt in flight at a time
                        requeue.append(req)
                    continue
                if req.prefix is None and req.pixels is None:
                    try:
                        plan = self._prefill_plan(req)
                    except ValueError as e:
                        req.done = True
                        req.error = str(e)
                        continue
                    groups.setdefault(plan[1], []).append((req, slot, plan))
                else:
                    singles.append((req, slot))
            for grp in groups.values():
                # power-of-two batches; a remainder of 1 takes the single path
                while len(grp) > 1:
                    b = 1 << (len(grp).bit_length() - 1)
                    pendings.extend(self._dispatch_prefill_batch(grp[:b]))
                    grp = grp[b:]
                singles.extend((req, slot) for req, slot, _ in grp)
            if requeue:
                self.queue = requeue + self.queue
            for req, slot in singles:
                try:
                    if req.prefix is not None:
                        pendings.append(self._dispatch_continue(req, slot))
                    else:
                        pendings.append(self._dispatch_prefill(req, slot))
                except ValueError as e:  # a per-request rejection
                    req.done = True
                    req.error = str(e)
            dispatched = self._dispatch_decode(gen)
            if pending_chunk is not None:
                pendings.append(pending_chunk)
            for p in pendings:
                self._insert_pending(p)
            if dispatched is not None:
                self._process_burst(dispatched)
            for p in pendings:
                self._finish_pending(p)
            self.round_stamps.append(time.perf_counter())
        return list(requests)
