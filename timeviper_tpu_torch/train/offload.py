"""Host-offloaded full-parameter training, layer by layer (counterpart of
timeviper_tpu/train/offload.py, the reference's ZeRO-3 + CPU offload analog,
configs/zero_configs/zero3.json:28-45).

* The f32 master weights and the AdamW moments live on the host as numpy
  arrays, keyed by the port's `NanoModel.state_dict()` names (`host_params`).
* The forward streams one layer's weights at a time to the card in the
  compute dtype, into one resident `NanoBlock` per block type, and keeps
  only the hidden states between layers. The layers are the port's blocks:
  the Mamba layers run K1 (ssd_scan) and the attention layers K2.
* The backward walks the layers in reverse: it streams each layer's weights
  again, recomputes its forward with autograd (K1 and K4, K2 and K2-bwd),
  pulls the layer's gradient back to the host in f32 and applies AdamW
  there while the card runs the next layer's backward; gradients never
  accumulate on the card.
* The embedding table goes to the card in the compute dtype once a step;
  its input gradient is scattered on the host (`np.add.at`). The loss head
  (final norm, logits, cross-entropy) runs over chunks of `logits_chunk`
  rows, each recomputed in the backward, so the (L, vocab) logits never
  exist whole.

On the card every transfer goes through pinned host buffers, two sets per
block type used in turn, each reused only after the copy that last read or
wrote it is done (a CUDA event), so host work (the f32 -> bf16 cast into a
buffer, AdamW) overlaps the card's. The card's copies of a layer are owned
buffers: `torch.from_numpy` shares the master's memory, which HostAdamW
updates in place (the JAX package's `_stage` guards the same hazard).
`StreamedTrainer.timing` splits a step by CUDA events into the spans of the
card's timeline spent staging weights in (the host's cast into a pinned
buffer and the copy), computing and pulling gradients out, each span with
the gaps the host leaves in it, and the host's AdamW seconds.

Where the port differs: the layer's small f32 leaves (norms, conv taps,
dt_bias, A_log, D) stream in f32, as the port's bf16 model keeps them; the
JAX trainer casts every leaf to the compute dtype.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from timeviper_tpu_torch.parallel.sharding import LATER
from timeviper_tpu_torch.config import NanoConfig
from timeviper_tpu_torch.data.fusion import IGNORE_INDEX
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.models.nano import NanoBlock, NanoModel, _block_forward
from timeviper_tpu_torch.ops.norms import rms_norm

HostParams = Dict[str, np.ndarray]


def host_params(model: NanoModel) -> HostParams:
    """The f32 master copy of a nano backbone's weights, as numpy arrays the
    caller owns."""
    return {k: v.detach().float().cpu().numpy().copy() for k, v in model.state_dict().items()}


class HostAdamW:
    """AdamW on host numpy, the JAX package's HostAdamW (optax.adamw's
    update: bias-corrected moments, decoupled weight decay on every leaf)."""

    def __init__(self, params_host: HostParams, lr=1e-5, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.step = 0
        self.mu = {k: np.zeros_like(p, np.float32) for k, p in params_host.items()}
        self.nu = {k: np.zeros_like(p, np.float32) for k, p in params_host.items()}

    def update_leaf(self, mu: np.ndarray, nu: np.ndarray, p: np.ndarray, g) -> None:
        """In-place AdamW on one leaf with its moments; the caller has
        advanced `step`."""
        t = self.step
        g = np.asarray(g, np.float32)
        mu *= self.b1
        mu += (1 - self.b1) * g
        nu *= self.b2
        nu += (1 - self.b2) * np.square(g)
        mhat = mu / (1 - self.b1 ** t)
        nhat = nu / (1 - self.b2 ** t)
        upd = mhat / (np.sqrt(nhat) + self.eps)
        if self.wd:
            upd = upd + self.wd * p
        p -= self.lr * upd

    def update_tree(self, sub_params: HostParams, sub_mu: HostParams, sub_nu: HostParams,
                    sub_grads: Dict[str, np.ndarray]) -> None:
        for k, p in sub_params.items():
            self.update_leaf(sub_mu[k], sub_nu[k], p, sub_grads[k])


class _Stager:
    """One block type's resident card block and its two sets of pinned host
    buffers (weights in, f32 gradients out) with the event that last used
    each."""

    def __init__(self, block: NanoBlock, pinned: bool):
        self.block = block
        self.names = [n for n, _ in block.named_parameters()]
        self.params = [p for _, p in block.named_parameters()]
        self.pinned = pinned
        if pinned:
            self.w_bufs = [[torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                            for p in self.params] for _ in range(2)]
            self.g_bufs = [[torch.empty(p.shape, dtype=torch.float32, pin_memory=True)
                            for p in self.params] for _ in range(2)]
            self.w_events: List[Optional[torch.cuda.Event]] = [None, None]


class StreamedTrainer:
    """Layer-streamed full-parameter LM fine-tuning of the nano backbone.

    host_params: the master copy (`host_params(model)`: the port's state_dict
    names, f32 numpy), updated in place by `train_step`. It runs on one
    device: a `mesh` of more than one rank raises. The card (or
    `device`) holds one block per block type, the embedding table and the
    step's hidden states. `pinned` (default: on a CUDA device) stages the
    transfers through the pinned, double-buffered host buffers; without it
    each copy is a blocking one from the masters."""

    def __init__(self, cfg: NanoConfig, host: HostParams, *, lr=1e-5, weight_decay=0.0,
                 compute_dtype=torch.bfloat16, logits_chunk: int = 2048, device=None,
                 pinned: Optional[bool] = None, mesh=None):
        if mesh is not None and mesh.size() > 1:
            raise NotImplementedError(f"the layer-streamed trainer on a mesh comes with the "
                                      f"next parallelism slice ({LATER})")
        self.cfg = cfg
        self.host = host
        self.dtype = compute_dtype
        self.logits_chunk = logits_chunk
        self.device = resolve_device(device)
        self.opt = HostAdamW(host, lr=lr, weight_decay=weight_decay)
        if pinned is None:
            pinned = self.device.type == "cuda"
        self.stagers = {bt: _Stager(NanoBlock(cfg, bt, compute_dtype, self.device), pinned)
                        for bt in dict.fromkeys(cfg.layers_block_type)}
        self._turn = 0  # which buffer set the next staging takes
        self.timing: Dict[str, float] = {}

    # -- transfers ---------------------------------------------------------

    def _to_device(self, name: str) -> torch.Tensor:
        """A host master in the compute dtype on the card, as an owned copy."""
        master = self.host[name]
        dtype = self.dtype if master.ndim >= 2 else torch.float32
        return torch.from_numpy(master).to(self.device, dtype, copy=True)

    @torch.no_grad()
    def _stage(self, i: int) -> Tuple[_Stager, int]:
        """Layer i's weights into its block type's resident block."""
        st = self.stagers[self.cfg.layers_block_type[i]]
        slot, self._turn = self._turn, self._turn ^ 1
        pre = f"layers.{i}."
        if not st.pinned:
            for n, p in zip(st.names, st.params):
                p.copy_(torch.from_numpy(self.host[pre + n]))
            return st, slot
        if st.w_events[slot] is not None:
            st.w_events[slot].synchronize()
        for n, p, buf in zip(st.names, st.params, st.w_bufs[slot]):
            buf.copy_(torch.from_numpy(self.host[pre + n]))
            p.copy_(buf, non_blocking=True)
        st.w_events[slot] = torch.cuda.Event()
        st.w_events[slot].record()
        return st, slot

    def _pull(self, st: _Stager, slot: int, grads) -> Tuple[List[np.ndarray], object]:
        """Start the f32 gradients' copy to the host; returns (host arrays,
        an event to wait on, or None)."""
        if not st.pinned:
            return [g.float().cpu().numpy() for g in grads], None
        bufs = st.g_bufs[slot]
        for buf, g in zip(bufs, grads):
            buf.copy_(g.float(), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return [b.numpy() for b in bufs], ev

    def _apply(self, i: int, st: _Stager, grads: List[np.ndarray], ev) -> None:
        if ev is not None:
            ev.synchronize()
        pre = f"layers.{i}."
        t0 = time.perf_counter()
        self.opt.update_tree({n: self.host[pre + n] for n in st.names},
                             {n: self.opt.mu[pre + n] for n in st.names},
                             {n: self.opt.nu[pre + n] for n in st.names},
                             dict(zip(st.names, grads)))
        self.timing["host_adam_s"] += time.perf_counter() - t0

    # -- the loss head -----------------------------------------------------

    def _head(self, norm_w: torch.Tensor, table: torch.Tensor, hidden: torch.Tensor,
              labels: torch.Tensor):
        """loss, d norm_f, d table, d hidden: the final norm, the f32 logits
        over the table and the masked cross-entropy, over chunks of
        `logits_chunk` rows recomputed in the backward."""
        eps, C = self.cfg.layer_norm_epsilon, self.logits_chunk

        def chunk_nll(w, tab, h, lab):
            logits = F.linear(rms_norm(h, w, eps).float(), tab.float())
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), lab.reshape(-1).long(),
                                   ignore_index=IGNORE_INDEX, reduction="sum")

        with torch.enable_grad():
            norm_w = norm_w.detach().requires_grad_(True)
            table = table.detach().requires_grad_(True)
            hidden = hidden.detach().requires_grad_(True)
            nll = sum(checkpoint(
                chunk_nll, norm_w, table, hidden[:, s:s + C], labels[:, s:s + C],
                use_reentrant=False) for s in range(0, hidden.shape[1], C))
            loss = nll / (labels != IGNORE_INDEX).sum().clamp(min=1)
            g_norm, g_table, dh = torch.autograd.grad(loss, [norm_w, table, hidden])
        return loss.detach(), g_norm, g_table, dh

    # -- the step ----------------------------------------------------------

    def train_step(self, input_ids: np.ndarray, labels: np.ndarray, shift: bool = True
                   ) -> float:
        """One AdamW step of every weight. Labels -100 are masked; `shift`
        scores labels[i] by the logits of row i - 1."""
        cfg, host, dev = self.cfg, self.host, self.device
        if shift:
            input_ids = np.asarray(input_ids)[:, :-1]
            labels = np.asarray(labels)[:, 1:]
        cuda = dev.type == "cuda"
        self.timing = {"host_adam_s": 0.0}
        marks: Dict[str, List] = {"stage": [], "compute": [], "pull": []}

        def mark(kind: str):  # (start, end) events around one part of the device's work
            if not cuda:
                return None
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            marks[kind].append(ev)
            return ev

        self.opt.step += 1  # once a step for every leaf
        ev = mark("stage")
        emb = self._to_device("embeddings.weight")
        tied = "lm_head.weight" not in host
        table = emb if tied else self._to_device("lm_head.weight")
        norm_w = self._to_device("norm_f.weight")
        ids = torch.from_numpy(np.ascontiguousarray(input_ids, np.int64)).to(dev)
        lab = torch.from_numpy(np.ascontiguousarray(labels, np.int64)).to(dev)
        if ev:
            ev[1].record()
        kinds = cfg.layers_block_type
        with torch.no_grad():
            h = F.embedding(ids, emb)
            hiddens = [h]
            for i in range(len(kinds)):
                ev = mark("stage")
                st, _ = self._stage(i)
                if ev:
                    ev[1].record()
                ev = mark("compute")
                h = _block_forward(st.block, cfg, h, None, False, 0)[0]
                hiddens.append(h)
                if ev:
                    ev[1].record()

        ev = mark("compute")
        loss, g_norm, g_table, dh = self._head(norm_w, table, hiddens[-1], lab)
        if ev:
            ev[1].record()

        pending = None
        for i in reversed(range(len(kinds))):
            ev = mark("stage")
            st, slot = self._stage(i)
            if ev:
                ev[1].record()
            ev = mark("compute")
            with torch.enable_grad():
                h_in = hiddens[i].detach().requires_grad_(True)
                out = _block_forward(st.block, cfg, h_in, None, False, 0)[0]
                *grads, dh = torch.autograd.grad(out, st.params + [h_in], dh)
            if ev:
                ev[1].record()
            ev = mark("pull")
            pulled = self._pull(st, slot, grads)
            if ev:
                ev[1].record()
            hiddens[i + 1] = None
            if pending is not None:
                self._apply(*pending)
            pending = (i, st, *pulled)
        if pending is not None:
            self._apply(*pending)

        ev = mark("pull")
        dh_np = dh.float().cpu().numpy()
        g_table_np = g_table.float().cpu().numpy()
        g_norm_np = g_norm.float().cpu().numpy()
        if ev:
            ev[1].record()
        t0 = time.perf_counter()
        g_emb = np.zeros_like(host["embeddings.weight"], np.float32)
        np.add.at(g_emb, np.asarray(input_ids).reshape(-1), dh_np.reshape(-1, dh_np.shape[-1]))
        opt = self.opt
        if tied:
            g_emb += g_table_np
        else:
            opt.update_leaf(opt.mu["lm_head.weight"], opt.nu["lm_head.weight"],
                            host["lm_head.weight"], g_table_np)
        opt.update_leaf(opt.mu["embeddings.weight"], opt.nu["embeddings.weight"],
                        host["embeddings.weight"], g_emb)
        opt.update_leaf(opt.mu["norm_f.weight"], opt.nu["norm_f.weight"],
                        host["norm_f.weight"], g_norm_np)
        self.timing["host_adam_s"] += time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize(dev)
            for kind, evs in marks.items():
                self.timing[f"{kind}_ms"] = sum(a.elapsed_time(b) for a, b in evs)
        return float(loss)

    def layer_bytes(self) -> Dict[str, int]:
        """Bytes a step moves: each layer's weights in twice (forward and
        backward) in the dtypes they stream in, their f32 gradients out
        once, and the embedding table (and an untied lm_head) in once."""
        w = g = 0
        for bt in self.cfg.layers_block_type:
            st = self.stagers[bt]
            w += 2 * sum(p.numel() * p.element_size() for p in st.params)
            g += 4 * sum(p.numel() for p in st.params)
        dsz = torch.empty((), dtype=self.dtype).element_size()
        tables = self.host["embeddings.weight"].size + (
            self.host["lm_head.weight"].size if "lm_head.weight" in self.host else 0)
        return {"h2d": w + tables * dsz, "d2h": g}
