"""Generation: bucketed prefill, then a greedy or sampled decode loop
(counterpart of timeviper_tpu/models/generate.py, its plain non-pdrop path).

  1. host: plan the fusion (data/fusion.py), pick a length bucket, LEFT-pad
     the fused row to it with segment id -1, so the Mamba state resets at the
     real start and attention never reaches the pads (segment mismatch in
     prefill, `valid_from` in decode);
  2. device: encode the frames clip by clip, then one prefill that fills the
     decode cache and gives the last row's f32 logits;
  3. host loop: one `decode_step` per token until a terminator or
     `max_new_tokens`; with `speculative="ngram"` and greedy sampling, the
     prompt-lookup loop of models/speculative.py instead (one verify pass of
     `n_draft + 1` rows where the history proposes drafts), token-identical.
     Every cache then holds `n_draft + 2` rows more (`_spec_margin`), for
     the verify's rows past the last accepted one.

Questions on a cached video: `prefill_prefix` prefills the shared part of
the prompt (system text and the video) once and returns a `PrefixState`;
`generate(question_ids, prefix=state)` then runs only the question on top of
it (models/prefix_cache.py:nano_forward_continue, or qwen2_forward_continue
for the qwen2 backbone) and decodes. One
PrefixState serves any number of questions: a continuation never writes
into it.

pdrop: `generate(use_pdrop=True)` and `prefill_prefix(use_pdrop=True)` on a
pdrop config run its stages inside the bucketed prefill, the visual block
starting after the left pad and the ranking query the bucket's last row
(the last prefix token for a prefix: question-agnostic, as in the JAX
package); the cache then carries each layer's `kv_len` and the TransV
`ca_kv`, which the continuation and every decode step merge again
(timeviper_tpu/models/generate.py:259-297, :528-553, :651-668).

Sequence parallelism: `Generator(mesh=make_mesh(seq=n))` runs the same
calls on every rank of the mesh's `seq` axis (parallel/seq_parallel.py). A
frame count that the axis divides is encoded frame-sharded (each rank its
span of frames, then one all-gather of the visual tokens; not for two towers
or InternVideo2), a nano bucket that it divides is prefilled
sequence-sharded into a cache every rank holds whole, and each rank decodes
that cache on its own card: every rank returns the same tokens. pdrop runs
masked inside the sharded prefill (the cache then carries `kv_valid` masks,
and speculation stays off on it). The same holds for `prefill_prefix`
(timeviper_tpu/models/generate.py:179-200, :299-330, :525-545, :621-645).

Tensor parallelism: `Generator(mesh=make_mesh(model=n))` shards the model in
place (parallel/tensor_parallel.py:shard_model, without FSDP, as the JAX
package's models/api.py:233-236 shards it) and runs at the local head
counts (`self.arch`); every rank takes the same calls and returns the same
tokens, the logits gathered whole. A mesh with both axes raises
(parallel/sharding.py:make_mesh).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from timeviper_tpu_torch.config import suffix_chunk
from timeviper_tpu_torch.data.fusion import FusionPlan, plan_fusion
from timeviper_tpu_torch.models.vlm import (
    VIT_FAMILIES,
    TimeViperVLM,
    VLMArch,
    decode_step,
    encode_visual,
    fuse_rows,
    vlm_forward,
)
from timeviper_tpu_torch.models.prefix_cache import forward_continue
from timeviper_tpu_torch.models.speculative import spec_decode, text_history
from timeviper_tpu_torch.ops.sampling import SamplingParams, sample_token
from timeviper_tpu_torch.parallel.seq_parallel import (
    encode_frames_seq_parallel,
    nano_prefill_seq_parallel,
)
from timeviper_tpu_torch.parallel.sharding import all_gather, axis_size
from timeviper_tpu_torch.parallel.tensor_parallel import serving_arch

DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def _fused_conv_default() -> bool:
    """TIMEVIPER_FUSED_CONV=1 routes the prefill's Mamba layers through the
    fused conv + scan (timeviper_tpu/models/generate.py:41); off by default."""
    return os.environ.get("TIMEVIPER_FUSED_CONV", "0") == "1"


def pad_text_to_bucket(ids_arr, gather_idx, bucket, pad_token_id):
    """Pad the text ids to the bucket length; visual gather entries (>= the
    text length) shift by the pad amount."""
    Lt = ids_arr.shape[0]
    if Lt >= bucket:
        return ids_arr, gather_idx
    ids_pad = np.concatenate([ids_arr, np.full((bucket - Lt,), pad_token_id, ids_arr.dtype)])
    gidx = np.asarray(gather_idx)
    gidx = np.where(gidx >= Lt, gidx + (bucket - Lt), gidx).astype(gidx.dtype)
    return ids_pad, gidx


def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


@dataclasses.dataclass
class GenerationOutput:
    token_ids: np.ndarray  # (num_generated,), includes the terminator if emitted
    num_generated: int
    first_logits: torch.Tensor  # (1, V) f32 logits of the prompt's last row
    encode_s: float  # host seconds, each phase ended by a device synchronize
    prefill_s: float
    decode_s: float
    # the speculative loop's counts (models/speculative.py:spec_decode), or None
    spec_stats: Optional[dict] = None


@dataclasses.dataclass
class PrefixState:
    """A cached prompt prefix (typically system text and a video): the decode
    cache after one prefill of it, reusable by any number of questions."""

    cache: dict
    bucket: int  # prefix rows filled (cache["length"]; before any pdrop drop)
    cache_len: int  # cache capacity
    suffix_budget: int  # the largest suffix bucket it can take
    pad: int = 0  # leading pad rows (cache["valid_from"])


def split_prompt_at_last_image(input_ids: Sequence[int], image_token_id: int):
    """(prefix_ids incl. the last <image> token, suffix_ids). The prefix is
    what is shared across questions on one video; the suffix is the
    question + options."""
    ids = list(input_ids)
    last = max(i for i, t in enumerate(ids) if t == image_token_id)
    return ids[: last + 1], ids[last + 1:]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Generator:
    """Batch-1 generation over one model on one device, or on every rank of
    a `seq` mesh (`mesh`, parallel/sharding.py:make_mesh; the module doc)."""

    def __init__(
        self,
        model: TimeViperVLM,
        arch: VLMArch,
        *,
        terminator_ids: Sequence[int],
        pad_token_id: int = 0,
        max_new_tokens: int = 128,
        sampling: SamplingParams = SamplingParams(),
        clip_size: int = 256,
        speculative: Optional[str] = None,
        n_draft: int = 7,
        mesh=None,
    ) -> None:
        if speculative not in (None, "ngram"):
            raise ValueError(f"unknown speculative mode {speculative!r}")
        self.mesh = mesh
        # a model axis shards the model in place; the arch is then the local one
        arch = serving_arch(model, arch, mesh)
        self.speculative = speculative
        self.n_draft = n_draft
        self.model = model
        self.arch = arch
        self.terminators = tuple(int(t) for t in terminator_ids)
        self.pad_token_id = pad_token_id
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.clip_size = clip_size
        self.device = model.llm_backbone.embeddings.weight.device

    @property
    def _seq_shards(self) -> int:
        return 1 if self.mesh is None else axis_size(self.mesh, "seq")

    def _shard_prefill(self, bucket: int) -> bool:
        """Whether a bucket's prefill runs sequence-sharded."""
        n = self._seq_shards
        return n > 1 and self.arch.llm_family == "nano" and bucket % n == 0

    @property
    def _spec_on(self) -> bool:
        """Speculation takes the greedy decode (acceptance compares argmax)."""
        return self.speculative == "ngram" and self.sampling.temperature == 0.0

    @property
    def _spec_margin(self) -> int:
        """Cache rows a verify pass may write past max_new_tokens."""
        return self.n_draft + 2 if self._spec_on else 0

    @torch.inference_mode()
    def encode_frames(self, pixels) -> torch.Tensor:
        """(F, H, W, 3) -> (F * tokens_per_frame, D), `clip_size` frames at a
        time. An InternVideo2 tower takes chunks of whole clips (a multiple of
        its num_frames) and raises ValueError on any other
        (models/internvideo2.py:encode_frames_iv2). With a `seq` mesh that
        divides the frames, each rank encodes its span and the spans are
        all-gathered (one ViT tower)."""
        n = self._seq_shards
        if (n > 1 and pixels.shape[0] % n == 0 and not self.arch.vision_backbones
                and self.arch.vision_family in VIT_FAMILIES):
            local = encode_frames_seq_parallel(self.model, self.arch, pixels, self.mesh,
                                               clip_size=self.clip_size)
            return all_gather(local[0], self.mesh, "seq", dim=0, tiled=True)
        pixels = torch.as_tensor(pixels, device=self.device)
        outs = [encode_visual(self.model, self.arch, pixels[s:s + self.clip_size])
                for s in range(0, pixels.shape[0], self.clip_size)]
        ve = torch.cat(outs, dim=0)
        return ve.reshape(-1, ve.shape[-1])

    def _plan_prompt(self, ids, image_token_id):
        """Left-pad the fused layout to a bucket, mask <image> placeholders to
        the pad token, pad the text ids. Returns (plan, bucket, pad, ids_arr,
        gather_idx, seq_idx)."""
        img = image_token_id if image_token_id is not None else -1
        plan = plan_fusion(ids, img, self.arch.tokens_per_frame)
        bucket = pick_bucket(plan.fused_len)
        pad = bucket - plan.fused_len
        gather_idx = np.concatenate([np.zeros((pad,), np.int32), plan.gather_idx])
        seq = (plan.seq_idx if plan.seq_idx is not None
               else np.zeros((plan.fused_len,), np.int32))
        seq_idx = np.concatenate([np.full((pad,), -1, np.int32), seq])
        ids_arr = np.asarray(ids, np.int32)
        ids_arr = np.where(ids_arr == img, self.pad_token_id, ids_arr)
        ids_arr, gather_idx = pad_text_to_bucket(ids_arr, gather_idx, bucket, self.pad_token_id)
        return plan, bucket, pad, ids_arr, gather_idx, seq_idx

    @torch.inference_mode()
    def prefill(self, ids_arr, gather_idx, seq_idx, visual, pad, cache_len,
                pdrop_vision_start: Optional[int] = None, shard: bool = True):
        """Bucketed prefill -> (last-row f32 logits (1, V), decode cache).
        `pdrop_vision_start` (the visual block's first row, the pad included)
        runs the pdrop stages with the bucket's last row as the query. With a
        `seq` mesh that divides the bucket (and `shard`), the prefill runs
        sequence-sharded (parallel/seq_parallel.py:nano_prefill_seq_parallel);
        under pdrop its cache holds `kv_valid` masks."""
        bucket = len(seq_idx)
        if shard and self._shard_prefill(bucket):
            llm = self.model.llm_backbone
            fused = fuse_rows(self.model, torch.as_tensor(ids_arr, dtype=torch.long,
                                                          device=self.device)[None],
                              visual[None], torch.as_tensor(np.asarray(gather_idx))[None])
            logits, cache = nano_prefill_seq_parallel(
                llm, self.arch.llm, fused, self.mesh, logits_to_keep=1, valid_from=pad,
                fill_cache=True, cache_max_len=cache_len,
                use_pdrop=pdrop_vision_start is not None, pdrop_vision_start=pdrop_vision_start,
                pdrop_num_vision=visual.shape[0], pdrop_query_pos=bucket - 1,
                merge_params=self.model.merge_modules, fused_conv=_fused_conv_default())
            return logits[:, -1], cache
        plan = FusionPlan(fused_len=bucket, text_len=len(ids_arr), num_visual=visual.shape[0],
                          gather_idx=gather_idx, is_visual=None, seq_idx=seq_idx,
                          position_ids=None, sample_layouts=())
        out = vlm_forward(
            self.model, self.arch,
            input_ids=torch.as_tensor(ids_arr, dtype=torch.long, device=self.device),
            plan=plan, visual_embeddings=visual, fill_cache=True, cache_max_len=cache_len,
            valid_from=pad, logits_to_keep=1, fused_conv=_fused_conv_default(),
            use_pdrop=pdrop_vision_start is not None, pdrop_vision_start=pdrop_vision_start,
            pdrop_query_pos=bucket - 1)
        return out["logits"][:, -1], out["cache"]

    def _pdrop_start(self, plan, pad: int, use_pdrop: bool) -> Optional[int]:
        """The pdrop prefill's vision start (pad + the sample's), or None
        without pdrop; pdrop generation is single-sample."""
        if not (use_pdrop and self.arch.llm.use_pdrop):
            return None
        if len(plan.sample_layouts) != 1:
            raise ValueError("pdrop generation is single-sample (packed rows train only)")
        return pad + plan.sample_layouts[0][0]

    @torch.inference_mode()
    def decode(self, first_logits, cache, rng_seed: int = 0) -> np.ndarray:
        """Sample the first token from the prefill logits, then step until a
        terminator or max_new_tokens."""
        gen = None
        if self.sampling.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        tok = sample_token(first_logits, gen, self.sampling)
        out = [int(tok[0])]
        while len(out) < self.max_new_tokens and out[-1] not in self.terminators:
            logits, cache = decode_step(self.model, self.arch, tok[:, None], cache)
            tok = sample_token(logits, gen, self.sampling)
            out.append(int(tok[0]))
        return np.asarray(out, np.int32)

    def prefill_prefix(
        self,
        input_ids: Sequence[int],
        pixels=None,
        image_token_id: Optional[int] = None,
        suffix_budget: int = 512,
        cache_len: Optional[int] = None,
        use_pdrop: bool = False,
    ) -> PrefixState:
        """Prefill a shared prompt prefix once and return a PrefixState for
        generate(prefix=...). The budget is raised to one SSD chunk at least
        (a suffix bucket is a multiple of the chunk; 16 rows for qwen2,
        config.py:suffix_chunk); the cache holds the
        bucket, the budget and max_new_tokens. `use_pdrop` runs the pdrop
        stages with the last prefix token as the ranking query."""
        suffix_budget = max(suffix_budget, suffix_chunk(self.arch.llm))
        visual = self.encode_frames(pixels) if pixels is not None else None
        plan, bucket, pad, ids_arr, gather_idx, seq_idx = self._plan_prompt(
            list(input_ids), image_token_id)
        visual = self._check_visual(plan, visual)
        need = bucket + suffix_budget + self.max_new_tokens + self._spec_margin
        cache_len = need if cache_len is None else cache_len
        if cache_len < need:
            raise ValueError(f"cache_len {cache_len} < prefix bucket {bucket} + suffix_budget "
                             f"{suffix_budget} + max_new_tokens {self.max_new_tokens} + "
                             f"the speculative margin {self._spec_margin}")
        _, cache = self.prefill(ids_arr, gather_idx, seq_idx, visual, pad, cache_len,
                                self._pdrop_start(plan, pad, use_pdrop))
        return PrefixState(cache=cache, bucket=bucket, cache_len=cache_len,
                           suffix_budget=suffix_budget, pad=pad)

    def _check_visual(self, plan, visual):
        """The visual tokens, or an empty (0, D) tensor without frames; raises
        if the prompt's <image> slots and the frames disagree."""
        nv = 0 if visual is None else visual.shape[0]
        if plan.num_visual != nv:
            raise ValueError(f"prompt has {plan.num_visual} visual slots, pixels give {nv}")
        if visual is None:
            emb = self.model.llm_backbone.embeddings.weight
            visual = emb.new_zeros(0, self.arch.llm.hidden_size)
        return visual

    def generate(
        self,
        input_ids: Sequence[int],
        pixels=None,
        image_token_id: Optional[int] = None,
        answer_prompt_ids: Optional[Sequence[int]] = None,
        use_pdrop: bool = False,
        rng_seed: int = 0,
        prefix: Optional[PrefixState] = None,
    ) -> GenerationOutput:
        """Generate a completion for one prompt (batch 1). With `prefix` (from
        prefill_prefix), `input_ids` is the suffix only (the question after
        the video) and `prefill_s` the seconds of its continuation.
        `use_pdrop` runs a pdrop config's stages in the prefill."""
        ids = list(input_ids) + list(answer_prompt_ids or [])
        if prefix is not None:
            return self._generate_on_prefix(ids, pixels, prefix, rng_seed)
        t0 = time.perf_counter()
        visual = self.encode_frames(pixels) if pixels is not None else None
        _sync(self.device)
        t1 = time.perf_counter()
        plan, bucket, pad, ids_arr, gather_idx, seq_idx = self._plan_prompt(ids, image_token_id)
        visual = self._check_visual(plan, visual)
        first_logits, cache = self.prefill(ids_arr, gather_idx, seq_idx, visual, pad,
                                           bucket + self.max_new_tokens + self._spec_margin,
                                           self._pdrop_start(plan, pad, use_pdrop))
        _sync(self.device)
        t2 = time.perf_counter()
        tokens, stats = self._run_decode(ids, first_logits, cache, rng_seed, image_token_id)
        t3 = time.perf_counter()
        return GenerationOutput(token_ids=tokens, num_generated=len(tokens),
                                first_logits=first_logits, encode_s=t1 - t0,
                                prefill_s=t2 - t1, decode_s=t3 - t2, spec_stats=stats)

    def _run_decode(self, ids, first_logits, cache, rng_seed: int, image_token_id=None):
        """(tokens, the speculative counts or None): the speculative loop when
        it is on (and the cache has no `kv_valid` masks), mining the prompt
        `ids` for drafts, else the plain one.
        The cache must be the loop's own."""
        if self._spec_on and cache.get("kv_valid") is None:
            buf, buf_len = text_history(ids, image_token_id, self.pad_token_id,
                                        self.max_new_tokens, self.n_draft)
            return spec_decode(self.model, self.arch, first_logits, cache, buf, buf_len,
                               max_new_tokens=self.max_new_tokens,
                               terminators=self.terminators, n_draft=self.n_draft)
        return self.decode(first_logits, cache, rng_seed), None

    def _generate_on_prefix(self, ids, pixels, prefix: PrefixState, rng_seed: int
                            ) -> GenerationOutput:
        """The JAX Generator's checks (ValueErrors, not asserts: a caller may
        catch them per item and fall back to a full prefill), then the
        continuation and the decode."""
        if pixels is not None:
            raise ValueError("the video already lives in the prefix cache")
        if not ids:
            raise ValueError("empty suffix on a cached prefix")
        chunk = suffix_chunk(self.arch.llm)
        sb = -(-len(ids) // chunk) * chunk
        if sb > prefix.suffix_budget:
            raise ValueError(f"suffix of {len(ids)} tokens needs a {sb}-token bucket (chunk "
                             f"multiple) > the prefix's suffix_budget {prefix.suffix_budget}")
        t0 = time.perf_counter()
        llm = self.model.llm_backbone
        with torch.inference_mode():
            embeds = llm.embeddings(torch.as_tensor([ids], dtype=torch.long, device=self.device))
            first_logits, cache = forward_continue(self.arch)(
                llm, self.arch.llm, embeds, prefix.cache, pdrop_params=self.model.merge_modules)
        _sync(self.device)
        t1 = time.perf_counter()
        # the continuation's cache holds copies of the prefix's K/V buffers
        # and new Mamba states: the loop may write it
        tokens, stats = self._run_decode(ids, first_logits, cache, rng_seed)
        t2 = time.perf_counter()
        return GenerationOutput(token_ids=tokens, num_generated=len(tokens),
                                first_logits=first_logits, encode_s=0.0, prefill_s=t1 - t0,
                                decode_s=t2 - t1, spec_stats=stats)
