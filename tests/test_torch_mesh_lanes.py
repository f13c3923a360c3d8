"""The port's mesh lanes against the reference's own ``shard_map`` lanes:
``decode_attention_dist`` (at divisible shapes and at the reference's
fallbacks), the expert-parallel branch of ``moe_forward`` and
``_moe_2d`` (granite and deepseek smoke variants, deepseek with shared
experts).

The reference runs once per module in a child process under
``--xla_force_host_platform_device_count=4`` over a
``jax.sharding.Mesh(...)`` mesh (not ``jax.make_mesh``, whose axes are
Explicit in JAX 0.9: ROADMAP C-ref2) and writes its inputs, drawn from
seeded NumPy, and outputs to an ``.npz``; the port runs the same inputs
on a mesh of ``(cpu,) * 4``, with whole operands and with the operands
a lane consumes sharded placed as blocks.  Everything is float32; held
within rtol 1e-5 / atol 1e-6 (the reference's own mesh/one-device
distance is ~1.7e-7).  The written caches are held too: the port writes
its blocks in place."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.tree import map_with_path
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention, moe
from repro_torch.sharding import rules

RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")

# name → (mesh (data, model), B, S, Hq, Hkv, D, pos)
ATTN_CASES = {
    "div_2x2": ((2, 2), 4, 64, 4, 2, 16, 37),
    "div_1x4": ((1, 4), 4, 64, 4, 2, 16, 63),
    "div_2x2_pos0": ((2, 2), 4, 64, 4, 2, 16, 0),
    "rows_replicated_2x2": ((2, 2), 3, 64, 4, 2, 16, 17),
    "s_indivisible_1x4": ((1, 4), 4, 66, 4, 2, 16, 40),
    "model1_4x1": ((4, 1), 4, 64, 4, 2, 16, 9),
    "no_context": (None, 4, 64, 4, 2, 16, 21),
}
# name → (arch, mesh, mode, B, S, moe_decode_2d)
MOE_CASES = {
    "granite_ep_2x2": ("granite-moe-1b-a400m", (2, 2), "prefill", 4, 3, False),
    "granite_ep_1x4": ("granite-moe-1b-a400m", (1, 4), "prefill", 2, 5, False),
    "granite_2d_2x2": ("granite-moe-1b-a400m", (2, 2), "decode", 4, 1, True),
    "deepseek_ep_2x2": ("deepseek-v2-236b", (2, 2), "prefill", 4, 3, False),
    "deepseek_2d_2x2": ("deepseek-v2-236b", (2, 2), "decode", 4, 1, True),
    "deepseek_local_4x1": ("deepseek-v2-236b", (4, 1), "decode", 4, 1, True),
}

_REFERENCE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config, smoke_variant
from repro.models import attention, moe
from repro.sharding import ShardCtx, use_ctx

ATTN, MOE = eval(sys.argv[2]), eval(sys.argv[3])
rng = np.random.default_rng(0)
out = {}

def ctx(shape):
    if shape is None:
        return use_ctx(None)
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return use_ctx(ShardCtx(Mesh(devs, ("data", "model"))))

for name, (mesh, b, s, hq, hkv, d, pos) in ATTN.items():
    arrs = {"q": (b, 1, hq, d), "k": (b, s, hkv, d), "v": (b, s, hkv, d),
            "kn": (b, 1, hkv, d), "vn": (b, 1, hkv, d)}
    arrs = {k: rng.standard_normal(v).astype(np.float32)
            for k, v in arrs.items()}
    with ctx(mesh):
        o, k2, v2 = attention.decode_attention_dist(
            arrs["q"], arrs["k"], arrs["v"], arrs["kn"], arrs["vn"],
            jnp.int32(pos))
    for k, v in arrs.items():
        out[f"attn/{name}/in/{k}"] = v
    out[f"attn/{name}/out"] = np.asarray(o)
    out[f"attn/{name}/k"] = np.asarray(k2)
    out[f"attn/{name}/v"] = np.asarray(v2)

for name, (arch, mesh, mode, b, s, two_d) in MOE.items():
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              moe_decode_2d=two_d)
    p = moe.moe_init(jax.random.PRNGKey(len(name)), cfg)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    with ctx(mesh):
        y = moe.moe_forward(p, jnp.asarray(x), cfg, mode=mode)
    flat, _ = jax.tree_util.tree_flatten_with_path(p)
    for path, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[f"moe/{name}/p/{key}"] = np.asarray(leaf)
    out[f"moe/{name}/x"] = x
    out[f"moe/{name}/y"] = np.asarray(y)
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
    path = tmp_path_factory.mktemp("mesh_lanes") / "ref.npz"
    child = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(path), repr(ATTN_CASES),
         repr(MOE_CASES)], capture_output=True, text=True, timeout=300,
        env=_child_env())
    assert child.returncode == 0, child.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _mesh(shape):
    return None if shape is None else make_host_mesh(*shape, device="cpu")


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _attn_lane(name) -> bool:
    mesh, _, s, *_ = ATTN_CASES[name]
    return mesh is not None and mesh[1] > 1 and s % mesh[1] == 0


def _moe_lane(name) -> str:
    _, (dsize, msize), mode, _, _, two_d = MOE_CASES[name]
    return ("2d" if two_d and mode == "decode" and msize > 1 and dsize > 1
            else "ep" if msize > 1 else "local")


# blocks only where a lane consumes them: the fallbacks take whole operands
ATTN_RUNS = [(n, placed) for n in ATTN_CASES for placed in (False, True)
             if not placed or _attn_lane(n)]
MOE_RUNS = [(n, placed) for n in MOE_CASES for placed in (False, True)
            if not placed or _moe_lane(n) != "local"]


@pytest.mark.parametrize("name,placed", ATTN_RUNS)
def test_decode_attention_dist_matches_reference(ref, name, placed):
    mesh_shape, b, s, hq, hkv, d, pos = ATTN_CASES[name]
    t = {k: torch.from_numpy(ref[f"attn/{name}/in/{k}"].copy())
         for k in ("q", "k", "v", "kn", "vn")}
    mesh = _mesh(mesh_shape)
    ctx = rules.ShardCtx(mesh) if mesh is not None else None
    k, v = t["k"], t["v"]
    lane = _attn_lane(name)
    if placed:
        bentry = ctx.batch_spec if rules.batch_split(ctx, b) > 1 else None
        spec = rules.P(bentry, "model", None, None)
        k, v = rules.place(k, spec, mesh), rules.place(v, spec, mesh)
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        kk = k if placed else k.clone()
        vv = v if placed else v.clone()
        with rules.use_ctx(ctx), rules.count_collectives() as log:
            out, k2, v2 = attention.decode_attention_dist(
                t["q"], kk, vv, t["kn"], t["vn"], p)
        _close(out, ref[f"attn/{name}/out"], f"{name} out pos={p!r}")
        for got, key in ((k2, "k"), (v2, "v")):
            whole = got.full() if placed else got
            _close(whole, ref[f"attn/{name}/{key}"], f"{name} {key}")
        assert log["by_op_count"]["all-reduce"] == (3 if lane else 0)
    if placed:
        assert isinstance(k2, rules.ShardedTensor) and k2 is k


def _moe_params(ref, name, cfg):
    gen = torch.Generator().manual_seed(0)
    shell = moe.moe_init(gen, cfg)
    return map_with_path(lambda path, _: torch.from_numpy(
        ref[f"moe/{name}/p/{path}"].copy()), shell)


@pytest.mark.parametrize("name,placed", MOE_RUNS)
def test_moe_mesh_lanes_match_reference(ref, name, placed):
    arch, mesh_shape, mode, b, s, two_d = MOE_CASES[name]
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              moe_decode_2d=two_d)
    p = _moe_params(ref, name, cfg)
    mesh = _mesh(mesh_shape)
    ctx = rules.ShardCtx(mesh)
    lane = _moe_lane(name)
    if placed:
        for key in moe._EXPERT_KEYS:
            spec = rules.P("model", None, None)
            if lane == "2d":
                spec = rules.P("model", "data", None) \
                    if key == "w_experts_out" else rules.P("model", None,
                                                           "data")
            p[key] = rules.place(p[key], spec, mesh)
    x = torch.from_numpy(ref[f"moe/{name}/x"].copy())
    with rules.use_ctx(ctx), rules.count_collectives() as log:
        y = moe.moe_forward(p, x, cfg, mode=mode)
    _close(y, ref[f"moe/{name}/y"], name)
    counts = log["by_op_count"]
    assert (counts["all-gather"], counts["all-reduce"]) == {
        "2d": (1, 1), "ep": (0, 1), "local": (0, 0)}[lane]
    # the same lane without a context is the one-device branch
    if not placed:
        with rules.use_ctx(None):
            y1 = moe.moe_forward(p, x, cfg, mode=mode)
        _close(y, y1.numpy(), f"{name} vs one device")
