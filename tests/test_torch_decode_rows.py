"""Per-row decode (models/nano.py:nano_decode_step with one length and one
valid_from per row, as the serving engine's slots decode): three rows at
different lengths, each with its own left pad, stepped together equal each
row stepped alone with the host-integer form, in logits and in every cache
entry. f32 on the CPU; tolerance 1e-5 (the batched step masks the keys
past a row's length where the batch-1 step slices them off, so sums run
over other shapes)."""

import numpy as np
import pytest
import torch
from torch_parity import rng

from timeviper_tpu_torch.config import NanoConfig
from timeviper_tpu_torch.models.cache import init_nano_cache
from timeviper_tpu_torch.models.nano import NanoModel, nano_decode_step, nano_forward

CFG = NanoConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=6,
                 hybrid_override_pattern="M-M*M-", num_attention_heads=2, head_dim=16,
                 num_key_value_heads=1, ssm_state_size=16, mamba_num_heads=4, mamba_n_groups=2,
                 mamba_head_dim=8, chunk_size=16)
MAX_LEN = 40


def _row_cache(model, ids, pad):
    """A left-padded prefill of one row: (last logits, its decode cache)."""
    seq = torch.tensor([[-1] * pad + [0] * (len(ids) - pad)], dtype=torch.int32)
    out = nano_forward(model, CFG, input_ids=torch.tensor([ids]), seq_idx=seq, fill_cache=True,
                       cache_max_len=MAX_LEN, valid_from=pad, logits_to_keep=1)
    return out["cache"]


def _stack(caches):
    batched = init_nano_cache(CFG, len(caches), MAX_LEN, torch.float32, "cpu")
    batched["length"] = torch.zeros(len(caches), dtype=torch.long)
    batched["valid_from"] = torch.zeros(len(caches), dtype=torch.long)
    for b, c in enumerate(caches):
        for bl, cl in zip(batched["layers"], c["layers"]):
            for key, val in cl.items():
                parts = val if isinstance(val, dict) else {None: val}
                for name, x in parts.items():
                    (bl[key][name] if name else bl[key])[b] = x[0]
        batched["length"][b] = c["length"]
        batched["valid_from"][b] = c["valid_from"]
    return batched


@torch.no_grad()
def test_rows_at_different_lengths_equal_batch1_steps():
    model = NanoModel(CFG, torch.float32, "cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    r = rng(0)
    rows = [(r.integers(1, 128, L).tolist(), pad) for L, pad in ((9, 3), (21, 0), (14, 5))]
    singles = [_row_cache(model, ids, pad) for ids, pad in rows]
    batched = _stack([_row_cache(model, ids, pad) for ids, pad in rows])
    assert batched["length"].tolist() == [9, 21, 14]
    toks = r.integers(1, 128, (3, len(rows))).tolist()
    for step in toks:
        logits, batched = nano_decode_step(model, CFG, torch.tensor(step)[:, None], batched)
        for b, tok in enumerate(step):
            want, singles[b] = nano_decode_step(model, CFG, torch.tensor([[tok]]), singles[b])
            np.testing.assert_allclose(logits[b].numpy(), want[0].numpy(), rtol=1e-5,
                                       atol=1e-5)
    assert batched["length"].tolist() == [s["length"] for s in singles] == [12, 24, 17]
    for b, single in enumerate(singles):
        for bl, sl in zip(batched["layers"], single["layers"]):
            for key, val in sl.items():
                parts = val if isinstance(val, dict) else {None: val}
                for name, x in parts.items():
                    got = bl[key][name] if name else bl[key]
                    if key in ("k", "v"):  # rows past a row's length are not its own
                        got, x = got[:, :single["length"]], x[:, :single["length"]]
                    np.testing.assert_allclose(got[b].numpy(), x[0].numpy(), rtol=1e-5,
                                               atol=1e-5)


def test_full_row_raises():
    model = NanoModel(CFG, torch.float32, "cpu")
    cache = init_nano_cache(CFG, 2, 4, torch.float32, "cpu")
    cache["length"] = torch.tensor([1, 4])
    cache["valid_from"] = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="full"):
        nano_decode_step(model, CFG, torch.ones(2, 1, dtype=torch.long), cache)
