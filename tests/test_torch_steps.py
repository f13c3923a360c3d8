"""``repro_torch.launch.steps.build_cell`` on a 4-device host mesh against
the reference's ``build_cell`` on its own: one train step
(``make_train_step``: autograd and AdamW, under the mesh context) and
one decode step (``decode_attn="dist"``, and for granite the 2-D MoE
lane) for smoke variants, all in float32 (both packages'
``DEFAULT_DTYPE`` swapped, as the reference's tests do).

The reference runs once per module in a child process under
``--xla_force_host_platform_device_count=4`` over a
``jax.sharding.Mesh(...)`` mesh (ROADMAP C-ref2: ``jax.make_mesh``'s
Explicit axes break its ``build_cell``), ``jax.jit(step,
in_shardings=...)``; the port's :class:`PlacedStep` places the same
inputs on ``(cpu,) * 4`` itself.  Held: the loss, the gradient norm, the
logits and every cache leaf within rtol 1e-5 / atol 1e-6.  The params
after the step: all but 0.1 % of the elements within atol 1e-2 · lr (the
bound ``tests/test_torch_train.py`` holds a step to), and none beyond
2 · lr.  A first AdamW step moves a weight by lr · g / (|g| + eps), so a
gradient within rounding of zero — the key biases' is zero exactly,
since the softmax cancels a shift shared by all of a query's scores —
may move it either way.

Also the elastic restore: a checkpoint placed under one mesh's
shardings restores under another's, every block equal to its slice of
the saved leaf."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.models.encdec as tencdec
import repro_torch.models.lm as tlm
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import leaves_with_path, map_with_path
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import PlacedStep, build_cell
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.sharding import rules

RTOL, ATOL = 1e-5, 1e-6
LR = AdamWConfig().lr
TRAIN = ShapeConfig("train_s", 16, 4, "train")
DECODE = ShapeConfig("decode_s", 64, 4, "decode")
# name → (arch, kind, mesh, config overrides)
CASES = {
    "qwen_train_2x2": ("qwen2.5-3b", "train", (2, 2), {}),
    "granite_train_2x2": ("granite-moe-1b-a400m", "train", (2, 2), {}),
    "qwen_decode_2x2": ("qwen2.5-3b", "decode", (2, 2),
                        {"decode_attn": "dist"}),
    "qwen_decode_1x4": ("qwen2.5-3b", "decode", (1, 4),
                        {"decode_attn": "dist"}),
    "granite_decode_2x2": ("granite-moe-1b-a400m", "decode", (2, 2),
                           {"decode_attn": "dist", "moe_decode_2d": True}),
}
POS = 37

_REFERENCE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro.models.lm as jlm
from repro.configs import get_config, smoke_variant
from repro.configs.base import ShapeConfig
from repro.launch.steps import build_cell
from repro.models import get_model
from repro.optim import AdamWConfig, adamw_init

jlm.DEFAULT_DTYPE = jnp.float32
CASES, TRAIN, DECODE, POS = eval(sys.argv[2])
TRAIN, DECODE = ShapeConfig(*TRAIN), ShapeConfig(*DECODE)
rng = np.random.default_rng(0)
out = {}

def flat(prefix, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in leaves:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)

for name, (arch, kind, shape, over) in CASES.items():
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = Mesh(devs, ("data", "model"))
    api = get_model(cfg)
    params = api.init_params(jax.random.PRNGKey(0), cfg)
    flat(f"{name}/params", params)
    if kind == "train":
        fn, _, sh, _ = build_cell(cfg, TRAIN, mesh)
        opt = adamw_init(params, AdamWConfig())
        tokens = rng.integers(0, cfg.vocab_size, (TRAIN.global_batch,
                              TRAIN.seq_len)).astype(np.int32)
        out[f"{name}/tokens"] = tokens
        p2, _, metrics = jax.jit(fn, in_shardings=sh)(
            params, opt, {"tokens": jnp.asarray(tokens)})
        out[f"{name}/loss"] = np.asarray(metrics["loss"])
        out[f"{name}/grad_norm"] = np.asarray(metrics["grad_norm"])
        flat(f"{name}/after", p2)
    else:
        fn, _, sh, _ = build_cell(cfg, DECODE, mesh)
        cache = api.init_cache(cfg, DECODE.global_batch, DECODE.seq_len,
                               dtype=jnp.float32)
        cache = jax.tree.map(lambda c: rng.standard_normal(c.shape).astype(
            np.float32) * 0.5, cache)
        flat(f"{name}/cache_in", cache)
        token = rng.integers(0, cfg.vocab_size,
                             (DECODE.global_batch,)).astype(np.int32)
        out[f"{name}/token"] = token
        logits, cache2 = jax.jit(fn, in_shardings=sh)(
            params, cache, jnp.asarray(token), jnp.int32(POS))
        out[f"{name}/logits"] = np.asarray(logits)
        flat(f"{name}/cache_out", cache2)
np.savez(sys.argv[1], **out)
"""


def _child_env() -> dict:
    env = dict(os.environ)
    inherited = [f for f in env.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(
        inherited + ["--xla_force_host_platform_device_count=4"])
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return env


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("steps") / "ref.npz"
    arg = repr((CASES, dataclasses.astuple(TRAIN),
                dataclasses.astuple(DECODE), POS))
    child = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                            arg], capture_output=True, text=True,
                           timeout=400, env=_child_env())
    assert child.returncode == 0, child.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def f32():
    saved = tlm.DEFAULT_DTYPE, tencdec.DEFAULT_DTYPE
    tlm.DEFAULT_DTYPE = tencdec.DEFAULT_DTYPE = torch.float32
    yield
    tlm.DEFAULT_DTYPE, tencdec.DEFAULT_DTYPE = saved


def _tree(ref, prefix, shell):
    return map_with_path(lambda path, _: torch.from_numpy(
        np.array(ref[f"{prefix}/{path}"])), shell)


def _case(name):
    arch, kind, shape, over = CASES[name]
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    api = get_model(cfg)
    shell = api.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, api, shell, make_host_mesh(*shape, device="cpu")


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().numpy(), want,
                               **(tol or {"rtol": RTOL, "atol": ATOL}),
                               err_msg=what)


@pytest.mark.parametrize("name", [n for n in CASES if "train" in n])
def test_build_cell_train_step_matches_reference(ref, f32, name):
    cfg, api, shell, mesh = _case(name)
    params = _tree(ref, f"{name}/params", shell)
    step, _, _, _ = build_cell(cfg, TRAIN, mesh)
    assert isinstance(step, PlacedStep)
    opt = adamw_init(params, AdamWConfig())
    batch = {"tokens": torch.from_numpy(ref[f"{name}/tokens"].copy())}
    before = {p: t.clone() for p, t in leaves_with_path(params)}
    new, _, metrics = step(params, opt, batch)
    _close(metrics["loss"], ref[f"{name}/loss"], "loss")
    _close(metrics["grad_norm"], ref[f"{name}/grad_norm"], "grad norm")
    diffs = []
    for path, leaf in leaves_with_path(new):
        diffs.append(np.abs(leaf.detach().numpy()
                            - ref[f"{name}/after/{path}"]).ravel())
        assert torch.equal(dict(leaves_with_path(params))[path],
                           before[path])          # new trees, as the ref
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR + ATOL
    assert np.mean(diffs > 1e-2 * LR) <= 1e-3, np.sort(diffs)[-10:]
    # the same step with no mesh (one device) gives the same loss
    one = build_cell(cfg, TRAIN, make_host_mesh(1, 1, device="cpu"))[0]
    _, _, m1 = one(params, adamw_init(params, AdamWConfig()), batch)
    _close(metrics["loss"], m1["loss"].numpy(), "loss vs one device")


@pytest.mark.parametrize("name", [n for n in CASES if "decode" in n])
def test_build_cell_decode_step_matches_reference(ref, f32, name):
    cfg, api, shell, mesh = _case(name)
    params = _tree(ref, f"{name}/params", shell)
    step, _, _, _ = build_cell(cfg, DECODE, mesh)
    cache_shell = api.init_cache(cfg, DECODE.global_batch, DECODE.seq_len,
                                 dtype=torch.float32, device="cpu")
    cache = _tree(ref, f"{name}/cache_in", cache_shell)
    token = torch.from_numpy(ref[f"{name}/token"].copy())
    placed = step.place_args(params, cache, token, POS)
    kv = [leaf for _, leaf in leaves_with_path(placed[1])]
    assert kv and all(isinstance(t, rules.ShardedTensor) for t in kv)
    if cfg.moe_decode_2d:
        experts = [leaf for path, leaf in leaves_with_path(placed[0])
                   if "w_experts" in path]
        assert experts and all(isinstance(t, rules.ShardedTensor)
                               for t in experts)
    with rules.count_collectives() as log:
        logits, cache2 = step(*placed)
    _close(logits, ref[f"{name}/logits"], "logits")
    for path, leaf in leaves_with_path(cache2):
        assert leaf is dict(leaves_with_path(placed[1]))[path]   # in place
        _close(leaf.full(), ref[f"{name}/cache_out/{path}"], path)
    assert log["by_op_count"]["all-reduce"] >= 3
    # the placed cache goes back in as it is: no second placement
    again = step.place_args(params, cache2, token, POS + 1)
    assert all(a is b for (_, a), (_, b) in zip(
        leaves_with_path(again[1]), leaves_with_path(cache2)))


def test_restore_onto_another_mesh(tmp_path):
    """Save a train state whole; restore it under (2, 2)'s shardings,
    then under (1, 4)'s and (4, 1)'s: every block is its slice of the
    saved leaf, and the whole reads back bit for bit."""
    cfg = smoke_variant(get_config("granite-moe-1b-a400m"))
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(1), cfg)
    state = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state, extra={"cursor": 3}, async_=False)
    saved = dict(leaves_with_path(state))
    for shape in ((2, 2), (1, 4), (4, 1)):
        mesh = make_host_mesh(*shape, device="cpu")
        _, _, (p_sh, o_sh, _), _ = build_cell(cfg, TRAIN, mesh)
        tree, extra, step = restore_latest(
            mgr, state, shardings={"params": p_sh, "opt": o_sh})
        assert step == 3 and extra == {"cursor": 3}
        sh = dict(leaves_with_path({"params": p_sh, "opt": o_sh}))
        for path, leaf in leaves_with_path(tree):
            assert isinstance(leaf, rules.ShardedTensor), path
            assert leaf.mesh == mesh and leaf.spec == rules.P(
                *sh[path].spec, *([None] * (leaf.ndim - len(sh[path].spec))))
            for c, blk in leaf.blocks.items():
                sl = tuple(slice(ci * n, (ci + 1) * n)
                           for ci, n in zip(c, leaf.block_shape))
                assert torch.equal(blk, saved[path][sl]), (path, c)
            assert torch.equal(leaf.full(), saved[path])
        if shape == (2, 2):
            emb = tree["params"]["embed"]
            assert emb.spec == rules.P("model", "data")
            assert len(emb.blocks) == 4


def test_opt_state_converts_under_the_mesh_step(ref, f32):
    """The reference's AdamW state for the same params drives the port's
    placed step to the same loss (the state moves between the
    packages)."""
    name = "qwen_train_2x2"
    cfg, api, shell, mesh = _case(name)
    params = _tree(ref, f"{name}/params", shell)
    opt = convert.opt_state_from_reference(
        {"m": map_with_path(lambda _, t: np.zeros(t.shape, np.float32),
                            params),
         "v": map_with_path(lambda _, t: np.zeros(t.shape, np.float32),
                            params),
         "step": np.zeros((), np.int32),
         "master": map_with_path(lambda _, t: t.numpy(), params)}, "cpu")
    step = build_cell(cfg, TRAIN, mesh)[0]
    _, _, metrics = step(params, opt, {
        "tokens": torch.from_numpy(ref[f"{name}/tokens"].copy())})
    _close(metrics["loss"], ref[f"{name}/loss"], "loss")
