"""``LM.prefill`` and ``LM.decode_step`` under a mesh: each model-axis rank
computes its heads, ff columns, experts, Mamba channels and vocabulary
columns, and holds its block of the cache as ``cache_pspecs`` places it —
the KV cache's sequence cut over ``model`` (over ``("data", "model")``
where a batch of one row does not split), the SSM state and conv window
on the channels — with decode's partial softmaxes merged over the
sequence's ranks.

olmo-1b, granite-moe-1b-a400m, gemma3-4b (sliding windows of 16 on every
layer), falcon-mamba-7b, jamba-v0.1-52b and qwen1.5-32b (with a float32
and with its ``float8_e4m3fn`` KV cache) at their smoke configs, from the
JAX package's weights (``jax.random.key(0)``, converted), run on gloo
ranks (``_torch_serve_fns.serve_cases``) on (1, 2) and (1, 4) ``("data",
"model")`` meshes with 4 prompts, on (2, 2) with one prompt, and granite
on the ep mesh (2, 2, 2) ``("expert", "data", "model")``, each expert rank
running its own experts on the tokens an all-to-all brings it: a prefill of
right-padded prompts of lengths 5, 21, 40 and 9 into a cache of 96
positions, then 12 decode steps fed the unsharded port's greedy tokens.
Each call's logits are held within 1e-5 x max|logit| of the unsharded
port's in the same process and within 1e-4 x max|logit| of the JAX
package's (its own greedy run, which must choose the same tokens); the
cache gathered from the ranks within 1e-5 x its max of the unsharded
port's (the float8 cache: see the test); every rank's cache is its block:
(B, 96/m, KV, hd) and (B, di/m, N). On the (1, 4) mesh rank 3's block
[72, 96) lies past every length, and gemma3's windows cross the edge at
24; a (1, 1) mesh computes the unsharded port's bits."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _torch_serve_fns as fns  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.models import LM, from_jax_params  # noqa: E402
from repro_torch.models.attention import decode_partials  # noqa: E402
from repro_torch.models.distributed import merge_blocks  # noqa: E402

ARCHS = ("olmo-1b", "granite-moe-1b-a400m", "gemma3-4b", "falcon-mamba-7b",
         "jamba-v0.1-52b", "qwen1.5-32b", "qwen1.5-32b fp8")
FP8 = {"kv_cache_dtype": "float8_e4m3fn"}
LENGTHS = (5, 21, 40, 9)
MAX_LEN = 96
STEPS = 12
PORT_TOL = 1e-5         # x max|logit|, against the unsharded port
JAX_TOL = 1e-4          # x max|logit|, against the JAX package
FP8_FLIPS = 1e-3        # of the cache's elements, a rounding step apart
FP8_TOL = 1e-2          # x max|logit|, the float8 cache's flips
MESHES = {"1x2": ((1, 2), ("data", "model"), 4),
          "1x4": ((1, 4), ("data", "model"), 4),
          "2x2-batch1": ((2, 2), ("data", "model"), 1)}
EP = ("ep-2x2x2", ((2, 2, 2), ("expert", "data", "model"), 4))
ONE = ("1x1", ((1, 1), ("data", "model"), 4))


def _cfgs(case):
    arch, _, fp8 = case.partition(" ")
    changes = FP8 if fp8 else {}
    return (dataclasses.replace(get_config(arch).smoke(), **changes),
            dataclasses.replace(jax_config(arch).smoke(), **changes))


def _port_run(cfg, state, toks, lens):
    """The unsharded port's prefill and STEPS greedy decode steps: the
    tokens each call chose, (STEPS, B), the sharded runs' feed."""
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(state)
    cache = lm.init_cache(len(lens), MAX_LEN)
    logits, cache = lm.prefill(cache, toks, lens)
    feed = []
    for step in range(STEPS):
        feed.append(logits.argmax(-1).numpy())
        logits, cache = lm.decode_step(cache, feed[-1][:, None], lens + step)
        logits = logits[:, 0]
    return np.stack(feed)


def _jax_run(jlm, params, toks, lens):
    """The JAX package's prefill and STEPS greedy decode steps: the logits
    of each call (B, V)."""
    prefill, decode = jax.jit(jlm.prefill), jax.jit(jlm.decode_step)
    logits, cache = prefill(params, jlm.init_cache(len(lens), MAX_LEN),
                            jnp.asarray(toks), jnp.asarray(lens))
    out = [np.asarray(logits)]
    for step in range(STEPS):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32).reshape(-1, 1)
        logits, cache = decode(params, cache, nxt, jnp.asarray(lens + step))
        logits = logits[:, 0]
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded runs (each world size's ranks in a thread, while the
    JAX package runs here): {(mesh, case): (rank results, JAX logits, fed
    tokens)}."""
    rng = np.random.default_rng(0)
    inputs, jax_in = {}, {}
    for case in ARCHS:
        cfg, jcfg = _cfgs(case)
        jlm = JaxLM(jcfg)
        params = jlm.init(jax.random.key(0))
        state = from_jax_params(cfg, jax.tree.map(np.asarray, params))
        toks = np.zeros((len(LENGTHS), max(LENGTHS)), np.int32)
        for i, n in enumerate(LENGTHS):
            toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
        lens = np.array(LENGTHS, np.int32)
        feed = _port_run(cfg, state, toks, lens)
        inputs[case, 4] = (cfg, state, toks, lens, MAX_LEN, feed)
        # one prompt: the third (rows do not mix)
        inputs[case, 1] = (cfg, state, toks[2:3], lens[2:3], MAX_LEN,
                           feed[:, 2:3])
        jax_in[case] = (jlm, params, toks, lens)
    spawns = [(1, [ONE]), (2, [("1x2", MESHES["1x2"])]),
              (4, [("1x4", MESHES["1x4"]),
                   ("2x2-batch1", MESHES["2x2-batch1"])]), (8, [EP])]
    tmp = tmp_path_factory.mktemp("serve")
    keys, futures = {}, {}
    with ThreadPoolExecutor(len(spawns)) as pool:
        for world, meshes in spawns:
            spec = dict(meshes)
            keys[world] = [(name, case) for name in spec for case in ARCHS
                           if name != EP[0] or case == "granite-moe-1b-a400m"]
            cases = [inputs[case, spec[name][2]] + spec[name][:2]
                     for name, case in keys[world]]
            futures[world] = pool.submit(run_ranks, fns.serve_cases, world,
                                         tmp, cases, timeout=240)
        jax_out = {case: _jax_run(*args) for case, args in jax_in.items()}
        out = {}
        for world, meshes in spawns:
            ranks = futures[world].result()
            spec = dict(meshes)
            for i, (name, case) in enumerate(keys[world]):
                b = spec[name][2]
                rows = slice(None) if b == 4 else slice(2, 3)
                out[name, case] = ([r[i] for r in ranks],
                                   [x[rows] for x in jax_out[case]],
                                   inputs[case, b][5])
    return out


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _fp8_steps(got, want) -> np.ndarray:
    """How many float8_e4m3fn values apart each element of two caches of
    float8 values (as float32) lies: their codes' distance, by sign and
    magnitude."""
    def codes(x):
        c = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8)
        c = c.numpy().astype(np.int32)
        return np.where(c & 0x80, -(c & 0x7F), c & 0x7F)
    return np.abs(codes(got) - codes(want))


CASES = [(name, case) for name in MESHES for case in ARCHS] + [
    (EP[0], "granite-moe-1b-a400m")]


@pytest.mark.parametrize("mesh,case", CASES)
def test_split_serving_matches_the_port_and_jax(runs, mesh, case):
    """The float8 cache rounds each K/V value to 3 mantissa bits, so a
    float32 difference of ~1e-7 between two sum orders (the split's
    all-reduced partial products, the unsharded products, the JAX
    package's) flips a rounding now and then, and a flipped element moves
    the later logits by up to 3.8e-4 x max|logit| (measured): there the
    cache is held element by element to one float8 step, on at most
    FP8_FLIPS of its elements, the greedy tokens equal, and the logits to
    FP8_TOL against both references (qwen's float32 cache holds the split
    itself at PORT_TOL)."""
    ranks, jax_logits, feed = runs[mesh, case]
    r0 = ranks[0]
    cfg = _cfgs(case)[0]
    fp8 = cfg.kv_cache_dtype == "float8_e4m3fn"
    m = MESHES.get(mesh, EP[1])[0][-1]
    flags = r0["split"]
    # the compute splits over model: every dim the smoke config divides
    assert flags["vocab"] and flags["heads"] == (cfg.n_heads > 0)
    assert flags["inner"] == cfg.is_ssm
    assert flags["experts"] or flags["moe_ff"] or not cfg.n_experts
    # the ep mesh's experts lie over ``expert``, a row a rank: tokens move
    assert flags["ep"] == r0["moves"] == (mesh == EP[0])
    for got, want, jwant in zip(r0["logits"], r0["want"], jax_logits):
        assert _rel(got, want) <= (FP8_TOL if fp8 else PORT_TOL)
        assert _rel(got, jwant) <= (FP8_TOL if fp8 else JAX_TOL)
    assert (fns.greedy(r0["logits"])[:STEPS] == feed).all()
    assert (fns.greedy(jax_logits) == fns.greedy(r0["logits"])).all()
    for got, want in zip(r0["cache"], r0["want_cache"]):
        assert got.shape == want.shape
        if fp8 and got.ndim == 5:
            steps = _fp8_steps(got, want)
            assert steps.max() <= 1 and (steps > 0).mean() <= FP8_FLIPS
        else:
            assert _rel(got, want) <= PORT_TOL
    # every rank holds its block of the sequence and of the channels
    seq_ranks = m * (2 if mesh == "2x2-batch1" else 1)
    blocks = sorted({r["seq"] for r in ranks})
    assert blocks == [(i * MAX_LEN // seq_ranks, MAX_LEN // seq_ranks,
                       seq_ranks) for i in range(seq_ranks)]
    b = 1 if mesh == "2x2-batch1" else len(LENGTHS) // r0["rows"]
    for r in ranks:
        assert all(r["again"])
        for shape in r["shapes"]:
            if len(shape) == 5:                 # KV: (stages, B, L/m, KV, hd)
                assert shape[1:] == (b, MAX_LEN // seq_ranks, cfg.n_kv_heads,
                                     cfg.head_dim_)
            elif shape[-1] == cfg.ssm_state:    # SSM state (.., B, di/m, N)
                assert shape[1:] == (b, cfg.d_inner // m, cfg.ssm_state)
            else:                               # conv (.., B, K-1, di/m)
                assert shape[1:] == (b, cfg.ssm_conv - 1, cfg.d_inner // m)


def test_the_edge_cases_are_in_the_data():
    """On the (1, 4) mesh rank 3's block lies past every length the run
    reaches, and gemma3's sliding window crosses the edge between blocks 0
    and 1 at some decode position."""
    block = MAX_LEN // 4
    assert 3 * block > max(LENGTHS) + STEPS
    window = get_config("gemma3-4b").smoke().sliding_window
    positions = [n + t for n in LENGTHS for t in range(STEPS)]
    assert any(p - window + 1 < block <= p for p in positions)


@pytest.mark.parametrize("case", ARCHS)
def test_one_rank_mesh_is_bit_for_bit(runs, case):
    (r0,), _, _ = runs["1x1", case]
    assert not any(r0["split"].values()) and r0["seq"] == (0, MAX_LEN, 1)
    for got, want in zip(r0["logits"], r0["want"]):
        assert np.array_equal(got, want)
    for got, want in zip(r0["cache"], r0["want_cache"]):
        assert np.array_equal(got, want)


MESH_16x16 = SimpleNamespace(axis_names=("data", "model"),
                             devices=np.empty((16, 16), dtype=object))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS[:-1])
def test_cache_split_is_the_plans_sequence_entry(shape, arch):
    """``cache_split`` reads the KV sequence's entry of ``cache_pspecs``:
    ``model``, or (data, model) where one row does not split over
    ``data``, as the JAX package's plan cuts the KV caches."""
    cfg, spec = get_config(arch), SHAPES[shape]
    got = shardings.cache_split(cfg, MESH_16x16, spec)
    assert got == (("data", "model") if spec.global_batch == 1
                   else ("model",))
    jcfg = jax_config(arch)
    shapes = jax.eval_shape(lambda: JaxLM(jcfg).init_cache(
        spec.global_batch, spec.seq_len))
    jspecs = jax.tree.leaves(jsh.cache_pspecs(shapes, jcfg, MESH_16x16,
                                              spec),
                             is_leaf=lambda x: isinstance(x, P))
    seq = {tuple(s)[2] for s, leaf in zip(jspecs, jax.tree.leaves(shapes))
           if leaf.ndim == 5}
    assert seq <= {got[0] if len(got) == 1 else got}
    assert seq or not cfg.n_heads


@pytest.mark.parametrize("window", [None, 5])
def test_merged_blocks_are_the_whole_softmax(window):
    """One token's attention over a cache cut into 4 blocks by hand, each
    block's partial softmax (``decode_partials``) merged
    (``merge_blocks``), against the softmax over the whole cache: rows of
    lengths 3 (blocks 1-3 wholly masked), 9 and 15 (a window across the
    edges), soft-capped logits."""
    cfg = dataclasses.replace(get_config("gemma3-4b").smoke(),
                              sliding_window=window, attn_logit_softcap=30.0)
    rng = np.random.default_rng(3)
    b, n, kv, hd = 3, 16, cfg.n_kv_heads, cfg.head_dim_
    q = torch.from_numpy(rng.standard_normal((b, cfg.n_heads, hd)
                                             ).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, n, kv, hd)).astype(
        np.float32)) for _ in range(2))
    lengths = torch.tensor([3, 9, 15])
    parts = [decode_partials(q, k[:, lo:lo + 4], v[:, lo:lo + 4], lengths,
                             cfg, lo=lo, is_global=False)
             for lo in range(0, n, 4)]
    got = merge_blocks(*(torch.stack(t) for t in zip(*parts)))
    qg = q.reshape(b, kv, cfg.n_heads // kv, hd)
    logits = torch.einsum("bkrh,btkh->bkrt", qg, k) * hd ** -0.5
    logits = 30.0 * torch.tanh(logits / 30.0)
    t = torch.arange(n)
    mask = t[None] <= lengths[:, None]
    if window:
        mask &= lengths[:, None] - t[None] < window
    w = torch.softmax(logits.masked_fill(~mask[:, None, None], -2.0 ** 30),
                      -1)
    want = torch.einsum("bkrt,btkh->bkrh", w, v)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
