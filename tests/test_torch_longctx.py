"""models/longctx.py: the layer-chunked long-context forward against the JAX
package's and against the port's own whole-sequence nano_forward, at
tiny_nano_config (6 layers, `M-M*M-`, chunk 16), f32, batch 2. L = 90 with
chunks of 32 rows: three Mamba chunks carry their conv windows and SSM
state, and the last one is 26 rows (JAX pads it at its tail). Tolerance 2e-4 on every row's
logits, the band tests/test_longctx.py allows the JAX forward against its
own whole-sequence one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import tiny_nano_config
from timeviper_tpu.models import longctx as jax_longctx
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu_torch.models.longctx import nano_forward_longctx
from timeviper_tpu_torch.models.nano import NanoModel, nano_forward
from timeviper_tpu_torch.params import nano_state_dict

TOL = dict(rtol=2e-4, atol=2e-4)


def test_longctx_matches_jax_and_the_whole_forward():
    cfg = tiny_nano_config()
    params = jax.jit(jax_nano.init_nano_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cfg, jnp.float32)
    model = NanoModel(cfg, torch.float32)
    model.load_state_dict(nano_state_dict(params, cfg))
    embeds = rng(0).standard_normal((2, 90, cfg.hidden_size), np.float32)
    want = jax.jit(lambda p, e: jax_longctx.nano_forward_longctx(
        p, cfg, e, chunk_tokens=32, logits_to_keep=0)["logits"])(params, jnp.asarray(embeds))
    got = nano_forward_longctx(model, cfg, t(embeds), chunk_tokens=32, logits_to_keep=0)
    np.testing.assert_allclose(n(got["logits"]), n(want), **TOL)
    with torch.no_grad():
        whole = nano_forward(model, cfg, inputs_embeds=t(embeds))
    np.testing.assert_allclose(n(got["logits"]), n(whole["logits"]), **TOL)
    np.testing.assert_allclose(n(got["hidden_states"]), n(whole["hidden_states"]), **TOL)
