"""The port's training half of parallelism (parallel/sharding.py's rules,
parallel/tensor_parallel.py, the Trainer on a mesh) against the JAX
package's, on the CPU.

* The rule table: every leaf of the tiny VLM pytree (nano with TransV, and
  qwen2), with FSDP and without, gets the spec JAX `params_shardings` gives
  it on a (data 2, seq 1, model 2) mesh.
* The fused ViT qkv's shard is split by heads within each of q, k and v.
* One 4-rank gloo spawn (tests/torch_mesh_ranks.py:train), the JAX side on
  the conftest's virtual devices while the ranks run: the full Trainer and a
  LoRA Trainer (`trainable_modules="projector"`, lora_b drawn off zero) on
  (data 2, model 2) with FSDP, as tests/test_train_loop.py:48 sets it up,
  against the JAX Trainer on the same mesh: three losses (the LoRA Trainer
  takes one step) to 1e-4 relative, every leaf's first-step gradient to
  rtol 1e-4 / atol 1e-6 of the leaf's scale (`_close_grads`; Adam's eps is
  1e-4: after one step an update is lr x sign(g) where g is near zero);
  the checkpoint written on the mesh, restored on one device, equals the
  gathered shards and resumes a one-device Trainer; qwen2 (Hq / Hkv 4 / 2,
  2 / 1 a rank: RoPE on the local heads, the q/k/v biases split with their
  columns, the vocabulary split) on (data 2, model 2) with FSDP, every
  first-step gradient against the one-device port's; on (1, 1, 4), where
  the KV heads (2) and the SSD groups (2) do not divide, attention and
  Mamba run whole and the gradients equal the one-device port's.
* The refusals of this slice: a seq and a model axis together, an int8 base
  on a mesh, the layer-streamed trainer on a mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks  # noqa: F401  (the rank module must import)
import torch_seq_ranks as ranks
from torch_parity import n

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_qwen2_config, tiny_vit_config
from timeviper_tpu.data import fusion as jfusion
from timeviper_tpu.data.loader import CollatedBatch as JaxBatch
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.parallel import sharding as jsh
from timeviper_tpu.train import lora as jax_lora
from timeviper_tpu.train.optim import OptimConfig as JaxOpt
from timeviper_tpu.train.trainer import Trainer as JaxTrainer
from timeviper_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.data import fusion as tfusion
from timeviper_tpu_torch.data.loader import CollatedBatch
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.parallel import tensor_parallel as tp
from timeviper_tpu_torch.parallel.sharding import make_mesh
from timeviper_tpu_torch.train.checkpoint import restore_checkpoint
from timeviper_tpu_torch.train.optim import OptimConfig
from timeviper_tpu_torch.train.step import grad_step, trainable_params
from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

IMG = 500
VLM = VLMConfig(arch_specifier="tome_mlp-2")
OPT = dict(learning_rate=3e-3, projector_lr=3e-3, total_steps=3, schedule="constant",
           eps=1e-4)
IDS = [5, 6, IMG, IMG, 9, 10, 11, 12]
PDROP = dict(use_pdrop=True, pdrop_type="uni_1_0.5-attn_3_0.25", merge_module="CrossAttention")


class StubMesh:
    """One rank of a mesh, as sharding the weights reads it (no collective)."""

    mesh_dim_names = ("data", "seq", "model")

    def __init__(self, shape, rank=0):
        self.shape, self.rank = shape, rank

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]

    def get_local_rank(self, axis):
        return self.rank


def _arch(llm_family="nano", **llm_kw):
    jllm = tiny_nano_config(**llm_kw) if llm_family == "nano" else tiny_qwen2_config(**llm_kw)
    tllm = (tcfg.tiny_nano_config(**llm_kw) if llm_family == "nano"
            else tcfg.tiny_qwen2_config(**llm_kw))
    arch = VLMArch(vlm=VLM, vision=tcfg.tiny_vit_config(), llm=tllm, llm_family=llm_family)
    jarch = jax_vlm.VLMArch(vlm=VLM, vision=tiny_vit_config(), llm=jllm, llm_family=llm_family)
    return arch, jarch


def _jax_params(jarch, seed=0):
    return jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), jarch, jnp.float32)


def _port(arch, params, lora=False):
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    if lora:
        from timeviper_tpu_torch.train.lora import add_lora

        add_lora(model, rank=4, alpha=8.0, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_numpy(params, arch))
    return model


def _jax_path(path) -> str:
    return jsh._path_str(path)


def _norm_spec(spec, ndim):
    return tuple((list(spec) + [None] * ndim)[:ndim])


@pytest.mark.parametrize("family", ["nano", "qwen2"])
@pytest.mark.parametrize("fsdp", [True, False])
def test_spec_of_every_leaf_is_jax_params_shardings(family, fsdp):
    arch, jarch = _arch(family, **(PDROP if family == "nano" else {}))
    params = _jax_params(jarch)
    jspecs = {}
    shard = jsh.params_shardings(params, jsh.make_mesh(data=2, model=2), fsdp_params=fsdp)
    for (path, leaf), (_, s) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                    jax.tree_util.tree_flatten_with_path(shard)[0]):
        jspecs[_jax_path(path)] = (_norm_spec(s.spec, leaf.ndim), leaf.shape)
    model = _port(arch, params)
    sizes = {"data": 2, "seq": 1, "model": 2}
    paths = tp.jax_param_paths(model)
    assert len(paths) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        path, kernel = paths[name]
        want, jshape = jspecs.pop(path)
        if name.endswith("patch_embed.weight"):  # a 4-D kernel in JAX, replicated
            jshape = (int(np.prod(jshape[:-1])), jshape[-1])
            assert set(want) == {None}
            want = (None, None)
        assert tuple(reversed(p.shape) if kernel else p.shape) == tuple(jshape), name
        assert tp.port_spec(path, kernel, p.shape, sizes, fsdp) == want, (name, want)
    # what JAX has beyond the port: the ViT's last block, which feeds no output
    last = f"vision_backbone/layers/{arch.vision.num_hidden_layers - 1}/"
    assert jspecs and all(k.startswith(last) for k in jspecs)


def test_vit_qkv_shard_is_split_by_heads_within_q_k_and_v():
    arch, jarch = _arch()
    params = _jax_params(jarch)
    whole = _port(arch, params)
    for rank in (0, 1):
        model = _port(arch, params)
        layout = tp.shard_model(model, arch, StubMesh((1, 1, 2), rank))
        w = whole.vision_backbone.layers[0].attn["qkv"].weight
        d = w.shape[1]
        q, k, v = w.split(d)
        half = d // 2
        want = torch.cat([x[rank * half:(rank + 1) * half] for x in (q, k, v)])
        got = model.vision_backbone.layers[0].attn["qkv"].weight
        assert got.shape == (3 * half, d) and torch.equal(got, want)
        assert layout.leaves["vision_backbone.layers.0.attn.qkv.bias"].qkv
        assert layout.arch.llm.num_attention_heads == arch.llm.num_attention_heads // 2


def _batches(arch, count=3, rows=2, seed=0):
    """count batches of `rows` rows, one plan (tests/test_train_loop.py's)."""
    r = np.random.default_rng(seed)
    labels = [-100] * 5 + [10, 11, 12]
    jplan = jfusion.plan_fusion(IDS, IMG, arch.tokens_per_frame)
    tplan = tfusion.plan_fusion(IDS, IMG, arch.tokens_per_frame)
    out = []
    for _ in range(count):
        batch = {"input_ids": np.stack([np.where(np.asarray(IDS) == IMG, 0, IDS)] * rows)
                 .astype(np.int32),
                 "labels": np.stack([jfusion.fuse_labels(jplan, labels)] * rows)
                 .astype(np.int32),
                 "pixels": r.standard_normal((rows, 2, 28, 28, 3)).astype(np.float32)}
        out.append((JaxBatch(batch=batch, plan=jplan), CollatedBatch(batch=batch, plan=tplan)))
    return out


def _lora_params(params):
    lp = jax_lora.add_lora(params, rank=4, alpha=8.0, key=jax.random.PRNGKey(1))
    r = np.random.default_rng(5)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(r.normal(0, 0.02, x.shape), x.dtype)
                         if _jax_path(path).endswith("lora_b") else x), lp)


def _jax_run(jarch, params, batches, lora, tmp):
    """The JAX Trainer's first-step gradients and its losses: three steps,
    or under LoRA the first step's loss alone."""
    cfg = JaxTrainerConfig(run_dir=str(tmp), max_steps=3, save_every=100, data_parallel=2,
                           model_parallel=2, resume=False, lora=lora,
                           trainable_modules="projector" if lora else None)
    # the trainer donates its state: it takes a copy
    jt = JaxTrainer(jarch, jax.tree_util.tree_map(jnp.array, params), JaxOpt(**OPT), cfg)
    jb, _ = batches[0]
    batch = {k: jax.device_put(jnp.asarray(v), jt.batch_sharding) for k, v in jb.batch.items()}
    with jt.mesh:
        metrics, grads = jt._get_grad(jb.plan)(jt.state.params, batch)
    grads = jax.device_get(grads)
    if lora:
        return [float(np.asarray(metrics["loss"]))], grads
    losses = [float(np.asarray(jt.train_step(b)["loss"])) for b, _ in batches]
    return losses, grads


def _lora_grads(grads, model):
    """LoRA's flat {JAX path: gradient} by the port's names."""
    inv = {path: (name, kernel) for name, (path, kernel) in tp.jax_param_paths(model).items()}
    out = {}
    for path, g in grads.items():
        name, kernel = inv[path]
        g = np.asarray(g)
        out[name] = torch.from_numpy(np.array(g.T if kernel else g))
    return out


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    folder = tmp_path_factory.mktemp("mesh_train")
    with ranks.running(torch_mesh_ranks.train, str(folder), world=4) as got:
        arch, jarch = _arch()
        params = jax.device_get(_jax_params(jarch))
        lparams = jax.device_get(_lora_params(params))
        batches = _batches(arch)
        model = _port(arch, params)
        qarch, qjarch = _arch("qwen2")
        qwen2 = _port(qarch, jax.device_get(_jax_params(qjarch, seed=3)))
        with torch.no_grad():  # biases off zero, so that a misplaced column shows
            g = torch.Generator().manual_seed(3)
            for name, p in qwen2.named_parameters():
                if name.endswith("_proj.bias"):
                    p.normal_(0.0, 0.5, generator=g)
        ranks.save_inputs(str(folder), arch=arch, state=model.state_dict(),
                          lora_state=_port(arch, lparams, lora=True).state_dict(),
                          batches=[tb for _, tb in batches], opt=OPT, qwen2_arch=qarch,
                          qwen2_state=qwen2.state_dict())
        want = {}
        for tag, p, lora in (("full", params, False), ("lora", lparams, True)):
            losses, grads = _jax_run(jarch, p, batches, lora, folder / f"jax_{tag}")
            want[tag] = {"losses": losses,
                         "grads": (_lora_grads(grads, _port(arch, p, lora)) if lora
                                   else from_jax_numpy(grads, arch))}
        # the one-device port's first-step gradients, for qwen2 on (2, 1, 2)
        # and the (1, 1, 4) mesh
        _, tb = batches[0]
        from timeviper_tpu_torch.data.loader import to_device

        batch = to_device(tb.batch, torch.device("cpu"))
        for tag, m, a in (("qwen2", qwen2, qarch), ("tp4", model, arch)):
            want[tag] = grad_step(m, a, trainable_params(m, False), batch, tb.plan,
                                  remat=True)[1]
    return arch, got, want


def _close_grads(got, want, rtol=1e-4, atol=1e-6):
    """rtol, and atol times the leaf's largest magnitude where that is above
    1: f32 sums in another order leave ~1e-6 of a leaf's scale on its small
    elements (a projector bias of scale 7 differs by 3.5e-6 from the
    one-device port, and from JAX, in one element)."""
    assert set(got) >= set(want) and want
    for name, w in want.items():
        w = n(w)
        np.testing.assert_allclose(n(got[name]), w, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("tag", ["full", "lora"])
def test_trainer_on_data2_model2_matches_jax_trainer(train_run, tag):
    _, got, want = train_run
    mine = got[0][tag]
    np.testing.assert_allclose(n(mine["losses"]), want[tag]["losses"], rtol=1e-4)
    np.testing.assert_array_equal(n(got[1]["losses"]), n(got[0]["full"]["losses"]))
    _close_grads(mine["grads"], want[tag]["grads"])
    if tag == "lora":  # the factors and the projector, nothing else
        assert all(".lora_" in k or k.startswith("projector.") for k in mine["grads"])


@pytest.mark.parametrize("tag", ["full", "lora"])
def test_mesh_checkpoint_restores_on_one_device(train_run, tag, tmp_path):
    arch, got, _ = train_run
    mine = got[0][tag]
    steps = 1 if tag == "lora" else 3
    state = restore_checkpoint(mine["ckpt"])
    assert state["step"] == steps and set(state["params"]) == set(mine["params"])
    for k, v in mine["params"].items():
        assert torch.equal(state["params"][k], v), k
    import os
    import shutil

    run = tmp_path / "run"
    shutil.copytree(os.path.dirname(mine["ckpt"]), run)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    if tag == "lora":
        from timeviper_tpu_torch.train.lora import add_lora

        add_lora(model, rank=4, alpha=8.0, generator=torch.Generator().manual_seed(0))
    tr = Trainer(arch, model, OptimConfig(**OPT),
                 TrainerConfig(run_dir=str(run), max_steps=steps, lora=tag == "lora",
                               trainable_modules="projector" if tag == "lora" else None),
                 device="cpu")
    assert tr.step == steps
    for k, p in tr.opt.params.items():
        assert torch.equal(p.detach(), mine["params"][k]), k


def test_qwen2_on_data2_model2_matches_one_device(train_run):
    arch, got, want = train_run
    mine = got[0]["qwen2"]
    assert mine["heads"] == (2, 1)
    _close_grads(mine["grads"], want["qwen2"])
    for p in ("q", "k", "v"):  # the biases are leaves of their own, split with the columns
        assert f"llm_backbone.layers.0.self_attn.{p}_proj.bias" in want["qwen2"]


def test_model4_runs_undivided_layers_whole(train_run):
    arch, got, want = train_run
    mine = got[0]["tp4"]
    whole = set(mine["whole"])
    a, m = arch.llm.attention_layer_indices[0], arch.llm.mamba_layer_indices[0]
    assert f"llm_backbone.layers.{a}.mixer.q_proj.weight" in whole
    assert f"llm_backbone.layers.{m}.mixer.in_proj.x.weight" in whole
    assert "llm_backbone.layers.1.mixer.up_proj.weight" not in whole  # 128 / 4 splits
    assert "llm_backbone.embeddings.weight" not in whole
    _close_grads(mine["grads"], want["tp4"])


def test_this_slice_refuses_what_the_next_one_takes():
    from timeviper_tpu_torch.train.offload import StreamedTrainer, host_params
    from timeviper_tpu_torch.train.quantize import quantize_params_int8

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        make_mesh(seq=2, model=2)
    arch, _ = _arch()
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    quantize_params_int8(model.llm_backbone, min_size=1)
    for shape in ((2, 1, 1), (1, 1, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
            tp.shard_model(model, arch, StubMesh(shape))
    llm = TimeViperVLM(arch, torch.float32, device="cpu").llm_backbone
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        StreamedTrainer(arch.llm, host_params(llm), device="cpu", mesh=StubMesh((2, 1, 1)))
