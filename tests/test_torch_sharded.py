"""The port's sharded lane and its serving supervisor on the CPU:
``repro_torch.sharding.rules``, ``core.backends.ShardedBackend``,
``runtime.{straggler,elastic}`` and ``runtime.resilience.
ServingSupervisor``, mirroring ``tests/test_sharded_backend.py``, the
straggler / elastic half of ``tests/test_runtime.py`` and the supervisor
tests of ``tests/test_resilience.py``, and held against ``repro``.

* A mesh may name one device more than once, so ``(cpu,) * D`` runs the
  partitioning at D = 1 … 4 in one process (the reference forces D host
  devices with ``XLA_FLAGS``).  Inside the port the sharded lane equals
  ``tiled`` bit for bit at every D, the ragged last tile (m0 = 10,
  t_m = 4), strides 1 and 2 and a linear-only model included.
* The contract behind those bits, call by call: in ``tiled`` and in
  ``sharded`` at D = 1, 2, 3, 4 and 8, each real output channel comes
  from a call with the same input shape and strides, weight shape,
  stride and row (the layer's output-channel groups), so the lanes agree
  whatever algorithm the library picks.  On the card a conv3_1-shaped
  layer is held bit for bit at D = 1, 2 and 4 (``-m cuda``).
* Against JAX: the port's D = 1 lane is within rtol 1e-4 / atol 1e-4 of
  the reference's ``sharded`` lane (the tolerance of
  ``tests/test_torch_api.py`` for ``tiled``); straggler actions, ratios
  and grids are equal on the same series; the ladder of a 4-device lane
  (rung names, surviving devices) equals the reference's, which runs in
  a child process under ``--xla_force_host_platform_device_count=4``.
* The supervised server runs one conv layer fed integer inputs within
  int8, so every lane — ``smm_kernel``, ``sharded`` and ``tiled`` — is
  exact integer arithmetic before the scale, and a degraded lane gives
  the clean run's bits.

Every wait and the child process carry their own timeout.  The
reference package is imported inside the tests, so the ``cuda`` test also
runs where JAX is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_sharded.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.api as tcodr
from repro_torch.core import backends
from repro_torch.core.backends import ShardedBackend
from repro_torch.core.engine import (CHANNEL_GROUPS, CodrConv2D, CodrLinear,
                                     channel_groups)
from repro_torch.runtime import resilience as res
from repro_torch.runtime.elastic import (ElasticMeshManager, HostSet,
                                         feasible_grid)
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor
from repro_torch.sharding import rules

T = 120                              # seconds any single wait may take
CPU = torch.device("cpu")
DS = [1, 2, 3, 4]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _sparse(rng, shape, density=0.5, scale=0.5):
    w = rng.normal(size=shape).astype(np.float32) * scale
    w[rng.random(shape) > density] = 0
    return w


def _conv_linear_layers(rng, m0=10, m1=6, n_out=5, hw=9):
    """conv → conv → linear; m0=10 with t_m=4 → ragged last tile."""
    w0 = _sparse(rng, (m0, 3, 3, 3))
    w1 = _sparse(rng, (m1, m0, 3, 3))
    wl = _sparse(rng, (n_out, m1 * (hw - 4) ** 2))
    b0 = rng.normal(size=m0).astype(np.float32)
    return lambda c: [c.LayerSpec.conv(w0, b0, activation="relu", name="c0"),
                      c.LayerSpec.conv(w1, activation="relu", name="c1"),
                      c.LayerSpec.dense(wl, name="fc")]


def _compile(layers, backend="tiled", **cfg):
    return tcodr.compile(tcodr.ModelSpec(layers(tcodr)),
                         tcodr.EncodeConfig(**cfg), backend=backend,
                         device="cpu")


def _np(y):
    return y.detach().cpu().numpy()


def _lane(d: int) -> ShardedBackend:
    return ShardedBackend((CPU,) * d, name=f"sharded_cpu{d}")


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def test_pad_to_multiple_matches_reference():
    from repro.sharding import rules as jrules
    for n, k in [(0, 4), (1, 4), (4, 4), (5, 4), (7, 1), (9, 3)]:
        assert rules.pad_to_multiple(n, k) == jrules.pad_to_multiple(n, k)
    assert rules.pad_to_multiple(0, 4) == 4     # floor: at least one block
    assert rules.pad_to_multiple(5, 4) == 8


def test_tile_mesh_default_and_repeats():
    from repro.sharding import rules as jrules
    assert rules.ENGINE_TILE_AXIS == jrules.ENGINE_TILE_AXIS == "tile"
    assert rules.tile_mesh(device="cpu") == (CPU,)
    assert rules.tile_mesh(["cpu"] * 3) == (CPU,) * 3
    with pytest.raises(ValueError, match="at least one device"):
        rules.tile_mesh([])
    if torch.cuda.is_available():
        assert len(rules.tile_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rules.tile_mesh()


@pytest.mark.parametrize("d", DS)
def test_shard_leading_pads_and_places(d, rng):
    x = rng.normal(size=(2 * d + 1, 3)).astype(np.float32)
    shards = rules.shard_leading(x, (CPU,) * d)
    assert len(shards) == d
    assert all(s.device == CPU and s.shape[0] == shards[0].shape[0]
               for s in shards)
    got = _np(torch.cat(shards))
    assert got.shape[0] == rules.pad_to_multiple(x.shape[0], d)
    np.testing.assert_array_equal(got[: x.shape[0]], x)
    assert (got[x.shape[0]:] == 0).all()        # zero pad rows


# ---------------------------------------------------------------------------
# parity: sharded vs tiled, bit for bit
# ---------------------------------------------------------------------------

def test_sharded_registered_with_caps():
    assert "sharded" in tcodr.available_backends()
    be = tcodr.get_backend("sharded")
    assert be.caps.supports_stride(3)           # any stride
    assert {"conv", "linear"} <= set(be.caps.native_kinds)
    assert be.caps.packed_matmul


@pytest.mark.parametrize("d", DS)
def test_sharded_matches_tiled_bit_for_bit(d, rng):
    compiled = _compile(_conv_linear_layers(rng), n_unique=16)
    x = rng.normal(size=(3, 9, 9, 3)).astype(np.float32)
    y_ti = _np(compiled.run(x, backend="tiled"))
    y_sh = _np(compiled.run(x, backend=_lane(d)))
    np.testing.assert_array_equal(y_sh, y_ti)
    # repeat requests reuse the placed shards and stay identical
    np.testing.assert_array_equal(_np(compiled.run(x, backend=_lane(d))),
                                  y_ti)
    assert compiled.model._run_sharded == (CPU,) * d


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("stride", [1, 2])
def test_sharded_single_layer_steps_match_layer_forward(stride, d, rng):
    w = _sparse(rng, (10, 3, 3, 3))             # ragged: 10 rows, t_m=4
    compiled = _compile(lambda c: [c.LayerSpec.conv(
        w, rng.normal(size=10).astype(np.float32), stride=stride,
        activation="relu", name="c0")])
    layer = compiled.model.layers[0]
    x = torch.from_numpy(rng.normal(size=(2, 11, 11, 3)).astype(np.float32))
    np.testing.assert_array_equal(_np(_lane(d).conv(layer, x)),
                                  _np(layer(x)))
    # one run of whole groups a device: 3 tiles → 3 groups, padded to D
    weights = layer._shard_state["weights"]
    assert len(weights) == d
    assert sum(map(len, weights)) == rules.pad_to_multiple(3, d)


@pytest.mark.parametrize("d", DS)
def test_sharded_linear_only_model(d, rng):
    wl = _sparse(rng, (7, 33))                  # ragged vs any device pad
    compiled = _compile(lambda c: [c.LayerSpec.dense(wl, name="fc")],
                        backend="sharded")
    x = rng.normal(size=(4, 33)).astype(np.float32)
    np.testing.assert_array_equal(_np(compiled.run(x, backend=_lane(d))),
                                  _np(compiled.run(x, backend="tiled")))


def test_sharded_explicit_mesh_and_custom_name(rng):
    """A ShardedBackend pinned to a mesh registers under its own name and
    dispatches like any other backend; the registered ``sharded`` takes
    the default mesh of the model's device."""
    be = tcodr.register(ShardedBackend([CPU] * 2, name="sharded_two"),
                        overwrite=True)
    assert be.n_devices == 2 and be.mesh == (CPU, CPU)
    compiled = _compile(_conv_linear_layers(rng), backend="sharded_two")
    x = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    y_ti = _np(compiled.run(x, backend="tiled"))
    np.testing.assert_array_equal(_np(compiled.run(x)), y_ti)
    default = tcodr.get_backend("sharded")
    assert default.mesh_for(CPU) == (CPU,)
    np.testing.assert_array_equal(_np(compiled.run(x, backend="sharded")),
                                  y_ti)
    assert compiled.model._run_sharded == (CPU,)


def test_new_mesh_reshards(rng):
    """Per-layer state is keyed on the mesh: a lane over another mesh
    re-shards, and the lane it replaced re-shards again on its return."""
    compiled = _compile(_conv_linear_layers(rng))
    x = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    compiled.run(x, backend=_lane(3))
    layer = compiled.model.layers[0]
    first = layer._shard_state
    assert first["mesh"] == (CPU,) * 3 and len(first["weights"]) == 3
    compiled.run(x, backend=_lane(3))
    assert layer._shard_state is first           # same mesh: cached
    compiled.run(x, backend=_lane(2))
    assert layer._shard_state["mesh"] == (CPU,) * 2
    assert compiled.model._run_sharded == (CPU,) * 2
    # the ragged stack's 3 tiles of t_m = 4 are 3 one-tile groups, padded
    # to 4: two groups of 4 channels a device, the first three the
    # layer's own group tensors
    weights = layer._shard_state["weights"]
    assert [[tuple(w.shape[:1]) for w in ws] for ws in weights] == \
        [[(4,), (4,)], [(4,), (4,)]]
    assert all(a is b for a, b in zip(weights[0] + weights[1],
                                      layer.groups_device))
    assert not weights[1][1].any()               # the zero pad group


def test_sharded_dispatch_site_fires(rng):
    compiled = _compile(_conv_linear_layers(rng))
    x = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    inj = res.FaultInjector(res.FaultPlan(
        [res.Fault(res.SITE_SHARDED_DISPATCH, 1, "device_loss")]))
    lane = _lane(2).set_fault_injector(inj)
    compiled.run(x, backend=lane)
    with pytest.raises(res.DeviceLost, match="sharded.dispatch#1"):
        compiled.run(x, backend=lane)
    assert inj.calls(res.SITE_SHARDED_DISPATCH) == 2
    lane.set_fault_injector(None)
    compiled.run(x, backend=lane)
    assert inj.calls(res.SITE_SHARDED_DISPATCH) == 2


def test_sharded_d1_matches_reference_sharded(rng):
    import repro.api as jcodr
    layers = _conv_linear_layers(rng)
    jc = jcodr.compile(jcodr.ModelSpec(layers(jcodr)),
                       jcodr.EncodeConfig(n_unique=16), backend="sharded")
    tc = _compile(layers, backend="sharded", n_unique=16)
    for x in (rng.normal(size=(3, 9, 9, 3)).astype(np.float32),
              rng.integers(-8, 8, size=(2, 9, 9, 3)).astype(np.float32)):
        np.testing.assert_allclose(_np(tc.run(x)), np.asarray(jc.run(x)),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the contract: every output channel from the same call in every lane
# ---------------------------------------------------------------------------

def _channel_calls(layer, lane, x) -> list:
    """Run ``layer`` on ``x`` through ``lane`` with the layer's float call
    (``_local``) recorded.  Each recorded call returns, in every output
    channel, a code naming the call and the channel's row in that call's
    weight, which the lane's gather, crop and scale carry through to the
    output (the layer has no bias and no activation).  Returns, for each
    real output channel, the call's input shape and strides, its weight
    shape, the stride, the row, and that row of the weight."""
    calls = []
    real = layer._local

    def record(xc, w):
        y = real(xc, w)
        calls.append((tuple(xc.shape), xc.stride(), tuple(w.shape),
                      getattr(layer, "stride", 1), w))
        code = len(calls) * 1024 + torch.arange(w.shape[0],
                                                dtype=torch.float32)
        return torch.zeros_like(y) + code

    layer._local = record
    try:
        y = lane.step(layer, x)
    finally:
        del layer._local
    codes = torch.round(y / layer.scale).reshape(-1, y.shape[-1])
    assert (codes == codes[0]).all()            # one call a channel
    out = []
    for code in codes[0].to(torch.int64).tolist():
        k, row = divmod(code, 1024)
        x_shape, x_stride, w_shape, stride, w = calls[k - 1]
        out.append(((x_shape, x_stride, w_shape, stride, row), w[row]))
    return out


def _contract_layer(case, rng):
    """(layer, input) for one case of the contract test."""
    if case == "linear":                        # 10 tiles, ragged last
        return (CodrLinear(_sparse(rng, (38, 33)), t_m=4, n_unique=16,
                           device="cpu"),
                torch.from_numpy(rng.normal(size=(4, 33)).astype(np.float32)))
    m, stride = {"ragged": (10, 1),             # 3 tiles, ragged last
                 "ragged_many": (38, 1),        # 10 tiles: 4 groups of 3
                 "stride2": (36, 2),            # 9 tiles
                 "fewer_tiles": (8, 1)}[case]   # 2 tiles: 2 groups
    layer = CodrConv2D(_sparse(rng, (m, 3, 3, 3)), t_m=4, stride=stride,
                       n_unique=16, device="cpu")
    x = rng.normal(size=(2, 11, 11, 3)).astype(np.float32)
    return layer, torch.from_numpy(x)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", ["ragged", "ragged_many", "stride2",
                                  "fewer_tiles", "linear"])
def test_every_channel_comes_from_the_same_call(case, d, rng):
    """``tiled`` and ``sharded`` over ``(cpu,) * d`` compute each real
    output channel in a call with the same input shape and strides, the
    same weight shape and stride, at the same row of an equal weight: the
    layer's fixed output-channel groups, whatever the mesh size."""
    layer, x = _contract_layer(case, rng)
    n_tiles = layer.tiles.shape[0]
    groups, per = channel_groups(n_tiles)
    assert groups == min(CHANNEL_GROUPS, n_tiles)
    assert groups * per >= n_tiles > groups * (per - 1)
    assert len(layer.groups_device) == groups
    want = _channel_calls(layer, backends.get_backend("tiled"), x)
    got = _channel_calls(layer, _lane(d), x)
    assert len(want) == len(got) == layer.code.shape[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert torch.equal(a, b)
    # the rows are the layer's decoded weights, channel for channel
    dense = torch.stack([w for _, w in want]).reshape(
        layer.code.shape[0], -1)
    np.testing.assert_array_equal(
        _np(dense), layer.decoded_weights().reshape(dense.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("benchmark", [False, True])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_cuda_conv3_1_sharded_equals_tiled_bit_for_bit(d, benchmark):
    """A VGG16 conv3_1-shaped layer (128 → 256 channels, 3×3) on a 214×214
    input: ``sharded`` over ``cuda:0`` repeated d times equals ``tiled``
    bit for bit, and ``tiled`` stays within 1e-4 of the dequantized
    oracle's range.  With ``benchmark`` the sharded lane runs first with
    cuDNN's autotuner on and ``tiled`` after it with it off, at a batch
    no earlier call used: the lanes' bits do not hang on that switch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (cuDNN picks its algorithms on "
                    "the card)")
    rng = np.random.default_rng(0)
    layer = CodrConv2D(_sparse(rng, (256, 128, 3, 3), 0.4), t_m=4,
                       n_unique=16, activation="relu", device="cuda")
    batch = 4 + d if benchmark else 4
    x = torch.from_numpy(rng.normal(size=(batch, 214, 214, 128))
                         .astype(np.float32)).cuda()
    lane = ShardedBackend(rules.tile_mesh(["cuda:0"] * d))
    saved = torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.benchmark = benchmark
        y_sh = lane.conv(layer, x)
        torch.backends.cudnn.benchmark = False
        y_ti = layer(x)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.benchmark = saved
    assert tuple(y_sh.shape) == (batch, 212, 212, 256)
    assert torch.equal(y_sh, y_ti)
    y_q = layer.quantized_reference(x)
    assert float((y_ti - y_q).abs().max()) <= 1e-4 * float(y_q.abs().max())


# ---------------------------------------------------------------------------
# straggler monitor and elastic grid, against the reference
# ---------------------------------------------------------------------------

def _same_series(n_hosts, cfg_kw, series):
    """Feed ``series`` to both monitors; every observation's median,
    ratios and actions equal.  Returns the port's last result."""
    from repro.runtime import straggler as jstraggler
    mon = StragglerMonitor(n_hosts, StragglerConfig(**cfg_kw)
                           if cfg_kw is not None else None)
    jmon = jstraggler.StragglerMonitor(
        n_hosts, jstraggler.StragglerConfig(**cfg_kw)
        if cfg_kw is not None else None)
    for t in series:
        got, want = mon.observe(t), jmon.observe(t)
        assert got["median"] == want["median"]
        np.testing.assert_array_equal(got["ratio"], want["ratio"])
        assert got["actions"] == want["actions"]
        np.testing.assert_array_equal(mon.flag_streak, jmon.flag_streak)
    return got, mon


def test_straggler_flags_slow_host():
    t = np.ones(8)
    t[3] = 2.5
    res_, _ = _same_series(8, {"patience": 3}, [t] * 10)
    assert res_["actions"].get(3) == "rebalance"


def test_straggler_recommends_eviction_when_severe():
    res_, _ = _same_series(4, {"patience": 2},
                           [np.array([1.0, 1.0, 1.0, 10.0])] * 6)
    assert res_["actions"].get(3) == "evict"


def test_straggler_no_false_positive_on_noise():
    rng = np.random.default_rng(0)
    res_, _ = _same_series(16, None, [rng.normal(1.0, 0.05, size=16)
                                      for _ in range(50)])
    assert not res_["actions"]


def test_straggler_all_equal_fleet_never_flags():
    res_, mon = _same_series(4, {"patience": 1}, [np.full(4, 0.25)] * 100)
    assert not res_["actions"] and not mon.flag_streak.any()


def test_straggler_zero_median_fleet_no_spurious_flags():
    res_, mon = _same_series(4, {"patience": 1},
                             [np.array([0.5, 0.0, 0.0, 0.0])] * 10)
    assert not res_["actions"] and not mon.flag_streak.any()
    assert np.all(res_["ratio"] == 1.0)
    res_, _ = _same_series(3, {"patience": 1},
                           [np.zeros(3)] + [np.array([1.0, 1.0, 5.0])] * 10)
    assert res_["actions"].get(2) == "evict"


@pytest.mark.parametrize("chips,mp,batch", [
    (256, 16, 256), (252, 16, 256), (12, 2, 16), (3, 1, 4), (7, 1, 7),
    (1, 2, 4), (3, 8, 64), (0, 1, 4), (4, 0, 4)])
def test_feasible_grid_matches_reference(chips, mp, batch):
    from repro.runtime import elastic as jelastic

    def call(fn):
        try:
            return fn(chips, model_parallel=mp, global_batch=batch)
        except ValueError as e:
            return ("ValueError", str(e))
    assert call(feasible_grid) == call(jelastic.feasible_grid)
    if (chips, mp) == (252, 16):
        assert feasible_grid(chips, model_parallel=mp,
                             global_batch=batch) == (8, 16)


def test_elastic_manager_failure_and_recovery():
    from repro.runtime import elastic as jelastic

    def fleet(mod):
        return mod.ElasticMeshManager(
            mod.HostSet(n_hosts=4, chips_per_host=4,
                        healthy=np.ones(4, dtype=bool)),
            model_parallel=2, global_batch=16)
    import repro_torch.runtime.elastic as telastic
    mgr, jmgr = fleet(telastic), fleet(jelastic)
    assert mgr.current_grid() == jmgr.current_grid() == (8, 2)
    for m in (mgr, jmgr):
        m.mark_failed(0)
    assert mgr.current_grid() == jmgr.current_grid()
    assert mgr.resume_plan(step=100) == jmgr.resume_plan(step=100)
    for m in (mgr, jmgr):
        m.mark_recovered(0)
    assert mgr.current_grid() == (8, 2)
    # the (data, model) mesh of devices the reference's Mesh is built over
    mesh = mgr.make_mesh([CPU] * 16)
    assert mesh.shape == (8, 2) and all(d == CPU for d in mesh.ravel())
    with pytest.raises(ValueError, match="need 16 devices, have 3"):
        mgr.make_mesh([CPU] * 3)


def test_elastic_manager_total_loss_raises_clear():
    mgr = ElasticMeshManager(HostSet(n_hosts=2, chips_per_host=1,
                                     healthy=np.ones(2, dtype=bool)),
                             model_parallel=1, global_batch=2)
    mgr.mark_failed(0)
    assert mgr.current_grid() == (1, 1)
    mgr.mark_failed(1)
    with pytest.raises(ValueError, match="0 surviving"):
        mgr.current_grid()


# ---------------------------------------------------------------------------
# supervisor: degradation ladder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def compiled():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(6, 3, 3, 3)).astype(np.float32) * 0.5
    w[rng.random(w.shape) > 0.5] = 0
    return tcodr.compile(tcodr.ModelSpec([tcodr.LayerSpec.conv(
        w, rng.normal(size=6).astype(np.float32), activation="relu",
        name="c0")]), tcodr.EncodeConfig(n_unique=16), backend="smm_kernel",
        device="cpu")


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(3)
    return [rng.integers(-127, 128, size=(9, 9, 3)).astype(np.float32)
            for _ in range(6)]


@pytest.fixture(scope="module")
def clean_ref(compiled, samples):
    """Outputs of a run with no resilience configured."""
    srv = compiled.serve(max_batch=2, flush_deadline_s=0.005)
    with srv:
        return [f.result(timeout=T)
                for f in [srv.submit_async(s) for s in samples]]


def _supervised_run(compiled, samples, lane, plan, **policies):
    """Serve ``samples`` under a supervisor over ``lane`` with ``plan``
    firing at the server's and the lane's sites."""
    inj = res.FaultInjector(plan)
    lane.set_fault_injector(inj)
    try:
        sup = res.ServingSupervisor(backend=lane, fallback="tiled",
                                    device="cpu")
        srv = compiled.serve(max_batch=2, flush_deadline_s=0.005)
        srv.configure_resilience(injector=inj, supervisor=sup, **policies)
        with srv:
            futs = [srv.submit_async(s) for s in samples]
            outs = [f.result(timeout=T) for f in futs]
    finally:
        lane.set_fault_injector(None)
    return sup, srv, futs, outs


def test_supervisor_device_loss_degrades_bit_identical(compiled, samples,
                                                       clean_ref):
    """An injected device loss on the sharded lane degrades to the next
    rung (tiled, on a one-device lane) and the dispatch that observed the
    loss retries there — outputs stay bit for bit."""
    sup, srv, _, outs = _supervised_run(
        compiled, samples, backends.resolve("sharded"),
        res.FaultPlan([res.Fault(res.SITE_SHARDED_DISPATCH, 1,
                                 "device_loss")]),
        retry_policy=res.RetryPolicy(max_retries=2, backoff_s=1e-3))
    for got, ref in zip(outs, clean_ref):
        np.testing.assert_array_equal(got, ref)
    assert sup.degradations >= 1
    assert sup.history[0]["from"] == "sharded"
    assert sup.backend_name == "tiled"
    assert srv.requests_served == len(samples)


def test_supervisor_ladder_exhaustion_falls_back_to_tiled():
    sup = res.ServingSupervisor(backend="sharded", fallback="tiled",
                                device="cpu")
    last = None
    for _ in range(32):                         # walk the whole ladder
        name = sup.degrade("test walk")
        if name is None:
            break
        last = name
    assert last == "tiled"                      # bottom rung
    assert sup.degrade("past bottom") is None   # exhausted: no-op
    assert sup.backend_name == "tiled"
    assert [h["from"] for h in sup.history][0] == "sharded"


def test_supervisor_latency_watch_degrades_on_sustained_slowness():
    sup = res.ServingSupervisor(
        backend="sharded", fallback="tiled", warmup=4, device="cpu",
        monitor_cfg=StragglerConfig(ewma_alpha=0.5, threshold=1.5,
                                    patience=2))
    for _ in range(4):                          # establish the baseline
        assert sup.record_latency(0.001) is None
    assert sup.baseline_s == pytest.approx(0.001)
    lane = None
    for _ in range(10):                         # sustained 20x slowness
        lane = sup.record_latency(0.02)
        if lane is not None:
            break
    assert lane is not None
    assert sup.degradations == 1
    assert "latency sustained" in sup.history[0]["reason"]
    # transient blips after the reset do not immediately re-degrade
    assert sup.record_latency(0.001) is None


def test_mixed_chaos_run_device_loss_no_loss_no_dup(compiled, samples,
                                                    clean_ref):
    """The server half of the reference's mixed chaos run: a dispatch
    failure, a worker crash, a device loss on the sharded lane and
    latency — no request lost or duplicated, every future resolves, the
    lane degrades with the clean run's bits."""
    plan = res.FaultPlan(
        [res.Fault(res.SITE_SERVER_DISPATCH, 0, "error"),
         res.Fault(res.SITE_SERVER_WORKER, 1, "crash"),
         res.Fault(res.SITE_SHARDED_DISPATCH, 2, "device_loss"),
         res.Fault(res.SITE_SERVER_DISPATCH, 4, "latency",
                   latency_s=0.003)])
    sup, srv, futs, outs = _supervised_run(
        compiled, samples, backends.resolve("sharded"), plan,
        retry_policy=res.RetryPolicy(max_retries=3, backoff_s=1e-3),
        restart_policy=res.RestartPolicy(max_restarts=2, backoff_s=1e-3))
    for got, ref in zip(outs, clean_ref):
        np.testing.assert_array_equal(got, ref)
    assert srv.requests_served == len(samples)
    assert srv.requests_quarantined == 0
    assert all(f.done() for f in futs)
    assert sup.degradations == 1 and sup.backend_name == "tiled"


_REFERENCE_LADDER = """
import json, numpy as np, jax
import repro.api as codr
from repro.core import backends
from repro.runtime import resilience as res
assert len(jax.devices()) == 4, jax.devices()
walk = res.ServingSupervisor(backend="sharded", fallback="tiled")
while walk.degrade("walk") is not None:
    pass
rng = np.random.default_rng(7)
w = rng.normal(size=(6, 3, 3, 3)).astype(np.float32) * 0.5
w[rng.random(w.shape) > 0.5] = 0
compiled = codr.compile(codr.ModelSpec([codr.LayerSpec.conv(
    w, rng.normal(size=6).astype(np.float32), activation="relu",
    name="c0")]), codr.EncodeConfig(n_unique=16))
rng = np.random.default_rng(3)
samples = [rng.integers(-127, 128, size=(9, 9, 3)).astype(np.float32)
           for _ in range(6)]
inj = res.FaultInjector(res.FaultPlan(
    [res.Fault(res.SITE_SHARDED_DISPATCH, 0, "device_loss"),
     res.Fault(res.SITE_SHARDED_DISPATCH, 2, "device_loss"),
     res.Fault(res.SITE_SERVER_DISPATCH, 1, "error")]))
lane = backends.resolve("sharded")
lane.set_fault_injector(inj)
sup = res.ServingSupervisor(backend="sharded", fallback="tiled")
srv = compiled.serve(max_batch=2)
srv.configure_resilience(injector=inj, supervisor=sup,
                         retry_policy=res.RetryPolicy(max_retries=3,
                                                      backoff_s=1e-3))
outs = srv.serve(samples)
lane.set_fault_injector(None)
rows = lambda s: [[h["from"], h["to"], h["surviving_devices"]]
                  for h in s.history]
print("LADDER " + json.dumps({"walk": rows(walk), "chaos": rows(sup),
                              "served": srv.requests_served,
                              "outs": [np.asarray(o).tolist()
                                       for o in outs]}))
"""


def test_four_device_ladder_matches_reference(compiled, samples):
    """A supervisor over a 4-device lane walks the reference's ladder:
    the rung names and surviving devices of a full walk and of a sync
    serve under two device losses and a dispatch error equal the
    reference's on a forced 4-device host platform; outputs agree at
    the ``tiled`` tolerance and equal a clean run's bits."""
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
    child = subprocess.run([sys.executable, "-c", _REFERENCE_LADDER],
                           capture_output=True, text=True, timeout=300,
                           env=env)
    assert child.returncode == 0, child.stderr[-2000:]
    line = [ln for ln in child.stdout.splitlines()
            if ln.startswith("LADDER ")][-1]
    want = json.loads(line[len("LADDER "):])

    def rows(sup):
        return [[h["from"], h["to"], h["surviving_devices"]]
                for h in sup.history]

    base = backends.register(ShardedBackend([CPU] * 4, name="sharded"),
                             overwrite=True)
    try:
        walk = res.ServingSupervisor(backend="sharded", fallback="tiled")
        while walk.degrade("walk") is not None:
            pass
        inj = res.FaultInjector(res.FaultPlan(
            [res.Fault(res.SITE_SHARDED_DISPATCH, 0, "device_loss"),
             res.Fault(res.SITE_SHARDED_DISPATCH, 2, "device_loss"),
             res.Fault(res.SITE_SERVER_DISPATCH, 1, "error")]))
        base.set_fault_injector(inj)
        sup = res.ServingSupervisor(backend="sharded", fallback="tiled")
        srv = compiled.serve(max_batch=2)
        srv.configure_resilience(
            injector=inj, supervisor=sup,
            retry_policy=res.RetryPolicy(max_retries=3, backoff_s=1e-3))
        outs = srv.serve(samples)
        base.set_fault_injector(None)
    finally:
        backends.register(ShardedBackend(), overwrite=True)
    assert rows(walk) == want["walk"]
    assert rows(walk)[-1][1] == "tiled"
    assert rows(sup) == want["chaos"]
    assert [r[1] for r in rows(sup)] == ["sharded@2", "sharded@2"]
    assert srv.requests_served == want["served"] == len(samples)
    clean = compiled.serve(max_batch=2).serve(samples)
    for got, ref, j in zip(outs, clean, want["outs"]):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, np.asarray(j, np.float32),
                                   rtol=1e-4, atol=1e-4)


def test_batcher_supervisor_records_step_latency():
    """The continuous batcher feeds each pooled step's wall time to its
    supervisor's latency watch (the reference's ``record_latency``)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.batching import ContinuousBatcher
    from repro_torch.models import get_model
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg)
    sup = res.ServingSupervisor(backend="sharded", warmup=1000,
                                device="cpu")
    cb = ContinuousBatcher(params, cfg, n_slots=2, max_len=16, device="cpu")
    assert cb.configure_resilience(supervisor=sup) is cb
    prompt = np.arange(1, 5, dtype=np.int32)
    out = cb.submit(prompt, max_new_tokens=4).result(timeout=T)
    cb.stop_async()
    assert len(out) == 4
    assert len(sup._warm) == cb.steps_run >= 3
    assert sup.degradations == 0 and sup.backend_name == "sharded"
