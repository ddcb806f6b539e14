"""``tests/test_kv_cache_dtype.py``'s case on the port: qwen1.5-32b's
smoke model decodes 10 steps of 2 sequences with a ``float8_e4m3fn`` KV
cache and with a float32 one, from the JAX package's weights
(``jax.random.key(0)``, converted) and tokens (``key(1)``), at the
reference's bounds: greedy agreement at least 0.95, the largest logit gap
below 1.0. Each of the port's two decodes is also held against the JAX
package's on the same weights and tokens (logits within 1e-5 x max|logit|,
the same greedy tokens). ``tests/test_torch_cuda.py`` runs the fp8 cache
on the card."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import dataclasses

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, from_jax_params  # noqa: E402

STEPS = 10


def test_qwen_config_uses_fp8_cache():
    assert get_config("qwen1.5-32b").kv_cache_dtype == "float8_e4m3fn"


def _decode(changes):
    """(the port's, the JAX package's) last-token logits per step."""
    cfg = dataclasses.replace(get_config("qwen1.5-32b").smoke(), **changes)
    jlm = JaxLM(dataclasses.replace(jax_config("qwen1.5-32b").smoke(),
                                    **changes))
    params = jlm.init(jax.random.key(0))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray,
                                                         params)))
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (2, STEPS), 0,
                                           cfg.vocab_size))
    cache, jcache = lm.init_cache(2, 20), jlm.init_cache(2, 20)
    if changes["kv_cache_dtype"] == "float8_e4m3fn":
        assert cache.k.dtype == torch.float8_e4m3fn
    port, ref = [], []
    for t in range(STEPS):
        logits, cache = lm.decode_step(cache, tokens[:, t:t + 1],
                                       np.full((2,), t))
        jlogits, jcache = jlm.decode_step(params, jcache,
                                          jnp.asarray(tokens[:, t:t + 1]),
                                          jnp.full((2,), t))
        port.append(logits[:, 0].float().numpy())
        ref.append(np.asarray(jlogits[:, 0]).astype(np.float32))
    return np.stack(port), np.stack(ref)


def test_fp8_cache_preserves_greedy_decode():
    a, ja = _decode({"kv_cache_dtype": "float8_e4m3fn"})
    b, jb = _decode({"kv_cache_dtype": "float32", "dtype": "float32"})
    for port, ref in ((a, ja), (b, jb)):
        assert np.abs(port - ref).max() <= 1e-5 * np.abs(ref).max()
        assert (port.argmax(-1) == ref.argmax(-1)).all()
    agree = (a.argmax(-1) == b.argmax(-1)).mean()
    assert agree >= 0.95, f"greedy agreement {agree}"
    assert np.abs(a - b).max() < 1.0
