"""The port's per-layer encoding search (``repro_torch.tune``, the CLI in
``repro_torch.launch.tune``) against ``repro.tune`` on the CPU.

Mirrors every test of ``tests/test_tune.py`` (the property twins of
``tests/test_tune_props.py`` are in ``tests/test_torch_tune_props.py``),
each run through both packages on the same NumPy-seeded inputs, and
holds the two to each other:

* the CNN lane is NumPy in both, so plans (exact and sampled grids), the
  best global config, the predicted numbers and ``layer_table`` agree
  exactly, character for character;
* compiled models run on ``tiled``: quality numbers agree within rtol
  1e-4 (the two frameworks sum the float32 convolutions in another
  order), bits and SRAM exactly;
* ``tune_params`` quantizes with torch and sums its norms in float64
  where the reference sums in float32: the same U per leaf, floats
  within rtol 1e-5.  The budgets used sit at least 1% away from every
  leaf's ``rel_err`` (checked below), so the last digits cannot move a
  pick;
* transformer logits: a plan carried between the packages (as JSON)
  keys the same leaves, and prefill logits in float32 activations agree
  within rtol / atol 1e-4 (``EXP`` of ``tests/test_torch_models.py``,
  the bound through attention's exponentials).

The tests of tuned plans on the card are in
``tests/test_torch_tune_cuda.py``, which imports no JAX.
"""
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jcodr
import repro_torch.api as codr
from repro import tune as jtune
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core import ucr as jucr
from repro.models import common as jcommon
from repro.models import get_model as jget_model
from repro.models import lm as jlm
from repro_torch import convert, tune
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import cost_model, dataflow, rle, ucr
from repro_torch.core.codr_linear import choose_bits
from repro_torch.core.dataflow import CODR_TILING, ConvShape
from repro_torch.core.serving import codr_report
from repro_torch.models import get_model
from repro_torch.models import lm as tlm

HW = (20, 20)
EXP = dict(rtol=1e-4, atol=1e-4)
QUALITY = ("top1_match", "mean_abs_logit_err", "rel_logit_err")


def _spec(pkg):
    return pkg.ModelSpec.from_paper_cnn(
        "vgg16", n_conv=2, n_out=10, ri=HW[0], ci=HW[1], density=0.4,
        rng=np.random.default_rng(0))


@pytest.fixture(scope="module")
def spec():
    return _spec(codr)


@pytest.fixture(scope="module")
def jspec():
    return _spec(jcodr)


@pytest.fixture(scope="module")
def grid():
    # exact scoring: predicted bits/SRAM must equal measured
    return tune.TuneGrid(max_vectors=None)


@pytest.fixture(scope="module")
def budget():
    return tune.TuneBudget(max_rel_err=0.03)


@pytest.fixture(scope="module")
def searches(spec, jspec):
    """Each package's exact-grid search from an empty cache: ``(plan,
    candidate table, best global (config, totals))``, port first."""
    out = []
    for pkg, s in ((tune, spec), (jtune, jspec)):
        pkg.clear_cache()
        grid = pkg.TuneGrid(max_vectors=None)
        budget = pkg.TuneBudget(max_rel_err=0.03)
        plan = pkg.tune_spec(s, HW, budget=budget, grid=grid)
        table = pkg.layer_candidate_table(s, HW, grid=grid)
        out.append((plan, table, pkg.best_global_config(
            table, budget=budget, grid=grid)))
    return out


@pytest.fixture(scope="module")
def plan(searches):
    return searches[0][0]


@pytest.fixture(scope="module")
def jplan(searches):
    return searches[1][0]


@pytest.fixture(scope="module")
def table(searches):
    return searches[0][1]


@pytest.fixture(scope="module")
def global_best(searches):
    return searches[0][2]


@pytest.fixture(scope="module")
def compiled_pair(spec, plan, global_best):
    gcfg, _ = global_best
    return (codr.compile(spec, plan=plan, device="cpu"),
            codr.compile(spec, gcfg, device="cpu"))


@pytest.fixture(scope="module")
def jcompiled_pair(jspec, searches):
    jplan, _, (gcfg, _) = searches[1]
    return jcodr.compile(jspec, plan=jplan), jcodr.compile(jspec, gcfg)


def _np(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.to(torch.float32).numpy()
    return np.asarray(y, np.float32)


def test_specs_are_the_same_weights(spec, jspec):
    assert [ls.name for ls in spec.layers] == [ls.name for ls in jspec.layers]
    for a, b in zip(spec.layers, jspec.layers):
        np.testing.assert_array_equal(np.asarray(a.weight),
                                      np.asarray(b.weight))


# ---------------------------------------------------------------------------
# the acceptance criterion: tuned plan strictly beats the best global
# config on predicted SRAM and measured bits/weight at equal agreement
# ---------------------------------------------------------------------------

def test_tuned_plan_strictly_dominates_best_global(spec, plan, global_best,
                                                   compiled_pair):
    gcfg, gpred = global_best
    tuned, baseline = compiled_pair
    assert plan.predicted_total_sram() < gpred["sram"]
    assert tuned.bits_per_weight() < baseline.bits_per_weight()
    x = tune.eval_batch(spec, HW, batch=32, seed=0)
    q_tuned = tune.cnn_quality(tuned, x)
    q_global = tune.cnn_quality(baseline, x)
    assert q_tuned["top1_match"] >= q_global["top1_match"]


def test_predicted_equals_measured_under_exact_grid(plan, compiled_pair):
    """Unsampled scoring: the plan's predicted bits and SRAM are the
    measured numbers, not estimates."""
    tuned, _ = compiled_pair
    assert plan.predicted_bits_per_weight() == \
        pytest.approx(tuned.bits_per_weight(), rel=1e-12)
    measured = sum(a.total_sram for _, a in
                   tuned.sram_report(HW, per_layer_tiling=True))
    assert plan.predicted_total_sram() == pytest.approx(measured, rel=1e-12)


def test_best_global_totals_match_candidate_table(table, budget, grid,
                                                  global_best):
    """Regression: the global scorer's totals are the per-layer sums for
    its chosen config."""
    gcfg, gpred = global_best
    expect_sram = expect_bits = 0.0
    for cands in table.values():
        tm = gcfg.t_m if cands[0].kind == "conv" else gcfg.t_m_linear
        match = [c for c in cands if c.n_unique == gcfg.n_unique
                 and c.t_m == tm and c.rle_params == gcfg.rle_params]
        assert len(match) == 1
        expect_sram += match[0].sram
        expect_bits += match[0].bits
    assert gpred["sram"] == pytest.approx(expect_sram)
    assert gpred["bits"] == pytest.approx(expect_bits)


def test_per_layer_optimum_never_worse_than_any_global(plan, global_best):
    _, gpred = global_best
    assert plan.predicted_total_sram() <= gpred["sram"]
    assert plan.predicted_total_bits() <= gpred["bits"]


# ---------------------------------------------------------------------------
# the two packages search alike
# ---------------------------------------------------------------------------

def test_plan_json_identical_to_the_reference(plan, jplan):
    """The same spec, exact grid and budget give the same ``TunePlan``
    JSON, and the same table text."""
    assert json.dumps(plan.to_json(), sort_keys=True) == \
        json.dumps(jplan.to_json(), sort_keys=True)
    assert not plan.meta["sampled"]
    assert plan.table() == jplan.table()


def test_sampled_plan_json_identical_to_the_reference(spec, jspec):
    """A sampled grid draws the same vectors in both packages: the same
    plan JSON (its predictions are estimates, and equal)."""
    kw = dict(max_vectors=64, n_uniques=(8, 256), t_ms_conv=(4,))
    plans = []
    for pkg, s in ((tune, spec), (jtune, jspec)):
        pkg.clear_cache()
        plans.append(pkg.tune_spec(s, HW, grid=pkg.TuneGrid(**kw),
                                   budget=pkg.TuneBudget(max_rel_err=0.03)))
    assert json.dumps(plans[0].to_json(), sort_keys=True) == \
        json.dumps(plans[1].to_json(), sort_keys=True)
    assert plans[0].meta["sampled"]


def test_candidate_table_and_global_config_equal_the_reference(searches):
    (_, table, (gcfg, gpred)), (_, jt, (jcfg, jpred)) = searches
    assert list(jt) == list(table)
    for name in table:
        assert [dataclasses.asdict(c) for c in table[name]] == \
            [dataclasses.asdict(c) for c in jt[name]]
    assert gcfg.metadata() == jcfg.metadata()
    assert gpred == jpred


def test_layer_table_equals_the_references(compiled_pair, jcompiled_pair):
    for t, j in zip(compiled_pair, jcompiled_pair):
        assert t.layer_table(HW) == j.layer_table(HW)
        assert t.layer_table() == j.layer_table()


def test_ucr_helpers_equal_the_reference(rng):
    w = rng.normal(size=(8, 5, 3, 3)).astype(np.float32)
    w[rng.random(w.shape) > 0.5] = 0
    q, _ = ucr.quantize_int8(w)
    for t_m, t_n in ((4, 4), (2, 3), (8, 1)):
        a = ucr.layer_ucr_vectors(q, t_m=t_m, t_n=t_n)
        b = jucr.layer_ucr_vectors(q, t_m=t_m, t_n=t_n)
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.unique_vals, v.unique_vals)
            np.testing.assert_array_equal(u.reps, v.reps)
            np.testing.assert_array_equal(u.indexes, v.indexes)
            assert u.density == v.density
        for n_unique, params in ((256, None), (16, None), (32, (3, 4, 5))):
            kw = dict(t_m=t_m, t_n=t_n, n_unique=n_unique, params=params)
            assert ucr.layer_code_size_only(w, **kw) == \
                jucr.layer_code_size_only(w, **kw)
    lin = rng.normal(size=(12, 7)).astype(np.float32)
    assert ucr.layer_code_size_only(lin, t_m=4, t_n=1) == \
        jucr.layer_code_size_only(lin, t_m=4, t_n=1)


# ---------------------------------------------------------------------------
# plan-aware compile: the degenerate plan IS the global-config path
# ---------------------------------------------------------------------------

def test_empty_plan_bit_identical_to_global_compile(spec):
    cfg = codr.EncodeConfig(n_unique=32)
    a = codr.compile(spec, cfg, device="cpu")
    b = codr.compile(spec, cfg, plan=tune.TunePlan(), device="cpu")
    assert a.total_bits() == b.total_bits()
    x = tune.eval_batch(spec, HW, batch=4, seed=1)
    assert torch.equal(a.run(x), b.run(x))


def test_one_entry_plan_matches_explicit_config(spec):
    cfg = codr.EncodeConfig(n_unique=32, t_m=8)
    as_dict = {ls.name: cfg for ls in spec.layers}
    a = codr.compile(spec, cfg, device="cpu")
    b = codr.compile(spec, plan=as_dict, device="cpu")
    assert a.total_bits() == b.total_bits()
    x = tune.eval_batch(spec, HW, batch=4, seed=1)
    assert torch.equal(a.run(x), b.run(x))


def test_plan_entry_type_error(spec):
    with pytest.raises(TypeError, match="must be an EncodeConfig"):
        codr.compile(spec, plan={spec.layers[0].name: 32}, device="cpu")
    # a config of the other package is no EncodeConfig of the port's
    with pytest.raises(TypeError, match="must be an EncodeConfig"):
        codr.compile(spec, plan={spec.layers[0].name: jcodr.EncodeConfig()},
                     device="cpu")


def test_layer_table_shows_plan_and_effective_tiles(compiled_pair, plan):
    tuned, _ = compiled_pair
    out = tuned.layer_table(HW)
    for name in plan.layers:
        assert name in out
    fc = next(line for line in out.splitlines() if line.startswith("fc"))
    # t_m_linear clamps to the 10 output features: the EFFECTIVE tile
    assert fc.split()[3] == "10"
    assert "pred b/w" in out and "pred sram" in out and "total" in out


def test_layer_table_without_plan_or_hw(spec, jspec):
    out = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                       device="cpu").layer_table()
    assert "-" in out                      # no plan, no sram: dash columns
    assert out == jcodr.compile(jspec, jcodr.EncodeConfig(
        n_unique=16)).layer_table()


# ---------------------------------------------------------------------------
# effective-tile stats
# ---------------------------------------------------------------------------

def test_linear_stats_record_effective_tile(spec):
    cfg = codr.EncodeConfig(n_unique=16, t_m_linear=512)
    compiled = codr.compile(spec, cfg, device="cpu")
    by_name = {st.name: st for st in compiled.stats()}
    assert by_name["fc"].t_m == 10          # clamped to out_features
    assert by_name["conv0"].t_m == cfg.t_m
    assert by_name["fc"].n_unique_budget == 16


# ---------------------------------------------------------------------------
# plan artifact: serialization + cache
# ---------------------------------------------------------------------------

def test_plan_json_roundtrip(plan, tmp_path):
    p = tmp_path / "plan.json"
    plan.save(str(p))
    loaded = tune.TunePlan.load(str(p))
    assert loaded.to_json() == plan.to_json()
    for name, lp in plan.layers.items():
        assert loaded.config_for(name) == lp.config
    assert loaded.budget == plan.budget


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_plan_files_load_in_the_other_package(plan, jplan, spec, jspec,
                                              direction, tmp_path):
    """A plan file either package writes loads in the other, to the same
    JSON, and compiles there to the same encoded bits."""
    path = str(tmp_path / "plan.json")
    if direction == "port_to_jax":
        plan.save(path)
        other = jtune.TunePlan.load(path)
        assert other.to_json() == plan.to_json()
        assert jcodr.compile(jspec, plan=other).total_bits() == \
            codr.compile(spec, plan=plan, device="cpu").total_bits()
    else:
        jplan.save(path)
        other = tune.TunePlan.load(path)
        assert other.to_json() == jplan.to_json()
        assert codr.compile(spec, plan=other, device="cpu").total_bits() \
            == jcodr.compile(jspec, plan=jplan).total_bits()
    assert open(path).read() == json.dumps(other.to_json(), indent=2)


def test_fingerprint_cache_hits_on_retune(spec, grid, budget):
    tune.clear_cache()
    p1 = tune.tune_spec(spec, HW, budget=budget, grid=grid)
    assert tune.cache_stats() == {"hits": 0, "misses": len(spec.layers)}
    assert not any(lp.from_cache for lp in p1.layers.values())
    p2 = tune.tune_spec(spec, HW, budget=budget, grid=grid)
    assert tune.cache_stats()["hits"] == len(spec.layers)
    assert all(lp.from_cache for lp in p2.layers.values())
    assert p1.to_json()["layers"].keys() == p2.to_json()["layers"].keys()
    assert p2.meta["cache_hits"] == len(spec.layers)


def test_fingerprint_sensitive_to_weights_and_geometry(rng):
    w = rng.normal(size=(8, 4, 3, 3)).astype(np.float32)
    base = tune.layer_fingerprint(w, "conv")
    assert tune.layer_fingerprint(w, "conv") == base        # deterministic
    assert tune.layer_fingerprint(w, "linear") != base
    assert tune.layer_fingerprint(w, "conv", stride=2) != base
    assert tune.layer_fingerprint(w * 2.0, "conv") != base
    # and the reference's key, for every variant
    for args in ((w, "conv"), (w, "linear"), (w, "conv", 2),
                 (w * 2.0, "conv")):
        assert tune.layer_fingerprint(*args) == \
            jtune.layer_fingerprint(*args)


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------

def test_bits_target_walks_below_unconstrained(spec, jspec, grid, table):
    free = tune.tune_spec(spec, HW, grid=grid,
                          budget=tune.TuneBudget(max_rel_err=0.03))
    target = free.predicted_bits_per_weight() * 0.9
    squeezed = tune.tune_spec(
        spec, HW, grid=grid,
        budget=tune.TuneBudget(max_rel_err=None,
                               target_bits_per_weight=target,
                               objective="bits"))
    assert squeezed.predicted_bits_per_weight() <= target
    assert squeezed.meta["meets_budget"]
    j = jtune.tune_spec(
        jspec, HW, grid=jtune.TuneGrid(max_vectors=None),
        budget=jtune.TuneBudget(max_rel_err=None,
                                target_bits_per_weight=target,
                                objective="bits"))
    assert {n: lp.as_dict() | {"from_cache": None}
            for n, lp in squeezed.layers.items()} == \
        {n: lp.as_dict() | {"from_cache": None} for n, lp in j.layers.items()}


def test_unreachable_sram_target_reported(spec, grid):
    plan = tune.tune_spec(
        spec, HW, grid=grid,
        budget=tune.TuneBudget(max_rel_err=None, max_sram_accesses=1.0))
    assert not plan.meta["meets_budget"]


def test_budget_validation():
    with pytest.raises(ValueError, match="objective"):
        tune.TuneBudget(objective="latency")
    with pytest.raises(ValueError, match="max_rel_err"):
        tune.TuneBudget(max_rel_err=-0.1)
    with pytest.raises(ValueError, match="target_bits_per_weight"):
        tune.TuneBudget(target_bits_per_weight=0)
    assert tune.TuneBudget(objective="energy").as_dict() == \
        jtune.TuneBudget(objective="energy").as_dict()


# ---------------------------------------------------------------------------
# EncodeConfig validation
# ---------------------------------------------------------------------------

def test_encode_config_tile_validation():
    with pytest.raises(ValueError, match="t_m must be >= 1"):
        codr.EncodeConfig(t_m=0)
    with pytest.raises(ValueError, match="t_n must be an integer"):
        codr.EncodeConfig(t_n=2.5)
    with pytest.raises(ValueError, match="t_m_linear must be an integer"):
        codr.EncodeConfig(t_m_linear=True)
    with pytest.raises(ValueError, match="n_unique must be in"):
        codr.EncodeConfig(n_unique=2)


def test_encode_config_rle_params_validation():
    with pytest.raises(ValueError, match=r"\(delta, rep, index\) triple"):
        codr.EncodeConfig(rle_params=(3, 3))
    with pytest.raises(ValueError, match="rep bit-length"):
        codr.EncodeConfig(rle_params=(3, 0, 3))
    with pytest.raises(ValueError, match="index bit-length"):
        codr.EncodeConfig(rle_params=(3, 3, 17))
    cfg = codr.EncodeConfig(rle_params=(np.int64(3), 4, 5))
    assert cfg.rle_params == (3, 4, 5)
    assert all(isinstance(b, int) for b in cfg.rle_params)


# ---------------------------------------------------------------------------
# eval harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,seed", [(8, 0), (3, 5)])
def test_eval_batch_equals_the_reference(spec, jspec, batch, seed):
    np.testing.assert_array_equal(
        tune.eval_batch(spec, HW, batch=batch, seed=seed),
        jtune.eval_batch(jspec, HW, batch=batch, seed=seed))
    lin = codr.ModelSpec([codr.LayerSpec.dense(
        np.ones((4, 6), np.float32), name="fc")])
    jlin = jcodr.ModelSpec([jcodr.LayerSpec.dense(
        np.ones((4, 6), np.float32), name="fc")])
    np.testing.assert_array_equal(
        tune.eval_batch(lin, HW, batch=batch, seed=seed),
        jtune.eval_batch(jlin, HW, batch=batch, seed=seed))


def test_cnn_quality_equals_the_reference(spec, compiled_pair,
                                          jcompiled_pair):
    x = tune.eval_batch(spec, HW, batch=8, seed=0)
    for t, j in zip(compiled_pair, jcompiled_pair):
        qt, qj = tune.cnn_quality(t, x), jtune.cnn_quality(j, x)
        assert qt["top1_match"] == qj["top1_match"]
        for k in QUALITY:
            assert qt[k] == pytest.approx(qj[k], rel=1e-4)


def test_pareto_curve_quality_improves_with_u(spec, jspec, plan, jplan):
    pts = tune.pareto_curve(spec, HW, n_uniques=(8, 256),
                            plans={"tuned": plan}, batch=8, device="cpu")
    by_tag = {p["tag"]: p for p in pts}
    assert set(by_tag) == {"U8", "U256", "tuned"}
    assert by_tag["U8"]["bits_per_weight"] < by_tag["U256"]["bits_per_weight"]
    assert by_tag["U8"]["rel_logit_err"] > by_tag["U256"]["rel_logit_err"]
    for p in pts:
        assert {"top1_match", "sram_accesses", "config"} <= set(p)
    jpts = jtune.pareto_curve(jspec, HW, n_uniques=(8, 256),
                              plans={"tuned": jplan}, batch=8)
    assert [p["tag"] for p in pts] == [p["tag"] for p in jpts]
    for p, q in zip(pts, jpts):
        for k in ("bits_per_weight", "sram_accesses", "config",
                  "top1_match"):
            assert p[k] == q[k], (p["tag"], k)
        for k in QUALITY[1:]:
            assert p[k] == pytest.approx(q[k], rel=1e-4), (p["tag"], k)


@pytest.fixture(scope="module")
def run_tune_pair():
    from repro.launch.tune import run_tune as jrun_tune
    from repro_torch.launch.tune import run_tune
    tune.clear_cache()
    jtune.clear_cache()
    return run_tune(verbose=False, device="cpu"), jrun_tune(verbose=False)


def test_run_tune_check_passes(run_tune_pair):
    from repro_torch.launch.tune import check_result
    check_result(run_tune_pair[0])         # raises on regression


def test_run_tune_equals_the_reference(run_tune_pair):
    t, j = run_tune_pair
    assert t["plan"].to_json() == j["plan"].to_json()
    assert t["global_config"].metadata() == j["global_config"].metadata()
    for lane in ("tuned", "global"):
        for k in ("bits_per_weight", "predicted_bits_per_weight",
                  "sram_accesses", "predicted_sram", "top1_match"):
            assert t[lane][k] == j[lane][k], (lane, k)
        for k in QUALITY[1:]:
            assert t[lane][k] == pytest.approx(j[lane][k], rel=1e-4)


def test_tune_cli_takes_the_references_flags(tmp_path, capsys,
                                            monkeypatch):
    """``main`` parses the reference's flags into the same ``run_tune``
    call, and ``--check`` gates as the reference's does."""
    from repro.launch import tune as jlaunch
    from repro_torch.launch import tune as tlaunch
    calls = []
    result = {"tuned": {"bits_per_weight": 1.0, "predicted_sram": 1.0,
                        "top1_match": 1.0},
              "global": {"bits_per_weight": 2.0, "predicted_sram": 2.0,
                         "top1_match": 1.0}}

    def fake(**kw):
        calls.append(kw)
        return result
    monkeypatch.setattr(tlaunch, "run_tune", fake)
    monkeypatch.setattr(jlaunch, "run_tune", fake)
    for argv in (["--small", "--check", "--objective", "bits",
                  "--out", str(tmp_path / "p.json")],
                 ["--model", "alexnet", "--hw", "24", "--target-bpw", "4",
                  "--max-sram", "1e6", "--max-rel-err", "0.05"]):
        tlaunch.main(argv)
        jlaunch.main(argv)
        assert calls[-2] == calls[-1]
    assert calls[0]["n_conv"] == 2 and calls[0]["input_hw"] == (20, 20)
    assert capsys.readouterr().out.count("CHECK OK") == 2
    result["tuned"]["bits_per_weight"] = 3.0
    with pytest.raises(AssertionError, match="bits/weight"):
        tlaunch.main(["--check"])


def test_run_tune_defaults_to_the_card():
    from repro_torch.launch.tune import run_tune
    if torch.cuda.is_available():
        pytest.skip("with a card run_tune runs there (chip_smoke.py)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tune(verbose=False)


# ---------------------------------------------------------------------------
# transformer lane: per-leaf plans through compile_params
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_setup():
    """(JAX cfg, api, params, port cfg, api, params): the port's params
    converted from the reference's."""
    jcfg = jsmoke(jget_config("qwen2.5-3b"))
    japi = jget_model(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = smoke_variant(get_config("qwen2.5-3b"))
    tparams = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, japi, jparams, tcfg, get_model(tcfg), tparams


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(3).integers(0, 512, (2, 8))


class _f32:
    """Both packages' model activations in float32 for the block."""

    def __enter__(self):
        self.saved = (tlm.DEFAULT_DTYPE, jcommon.DEFAULT_DTYPE,
                      jlm.DEFAULT_DTYPE)
        tlm.DEFAULT_DTYPE = torch.float32
        jcommon.DEFAULT_DTYPE = jlm.DEFAULT_DTYPE = jnp.float32

    def __exit__(self, *exc):
        (tlm.DEFAULT_DTYPE, jcommon.DEFAULT_DTYPE,
         jlm.DEFAULT_DTYPE) = self.saved


def test_compile_params_empty_plan_bit_identical(lm_setup, tokens):
    *_, tcfg, tapi, tparams = lm_setup
    ecfg = codr.EncodeConfig(n_unique=16)
    a = codr.compile_params(tparams, ecfg, accounting=False, device="cpu")
    b = codr.compile_params(tparams, ecfg, accounting=False,
                            plan=tune.TunePlan(), device="cpu")
    t = {"tokens": torch.from_numpy(tokens)}
    la, _ = tapi.prefill(a.params, t, tcfg)
    lb, _ = tapi.prefill(b.params, t, tcfg)
    assert torch.equal(la, lb)
    assert a.bits_per_weight() == b.bits_per_weight()


def test_tune_params_per_leaf_plan_shrinks_hbm(lm_setup):
    *_, tparams = lm_setup
    plan = tune.tune_params(tparams,
                            budget=tune.TuneBudget(max_rel_err=0.2),
                            n_uniques=(4, 8, 16, 32))
    assert plan.layers                      # found packable projections
    assert all(lp.kind == "linear" for lp in plan.layers.values())
    us = {lp.config.n_unique for lp in plan.layers.values()}
    max_u = max(us)
    tuned = codr.compile_params(tparams, plan=plan, device="cpu",
                                config=codr.EncodeConfig(n_unique=max_u))
    flat = codr.compile_params(tparams, codr.EncodeConfig(n_unique=max_u),
                               device="cpu")
    assert tuned.hbm_bytes() <= flat.hbm_bytes()
    if len(us) > 1:                         # heterogeneous U picked
        assert tuned.hbm_bytes() < flat.hbm_bytes()
    report = codr_report(tuned.reports, per_tensor=True)
    assert "tensor" in report
    assert any(p in report for p in tuned.packed_paths)


# every leaf's rel_err of the smoke qwen2.5-3b at U = 4, 8, 16, 32 lies in
# [0.67, 0.76], [0.29, 0.34], [0.141, 0.165] or [0.070, 0.083]: these
# budgets are at least 1% from each, so float32 vs float64 norms (1e-7
# apart) cannot move a pick; 0.15 mixes U = 16 and U = 32
@pytest.mark.parametrize("max_rel_err", [0.2, 0.15, 0.1, None])
def test_tune_params_equals_the_reference(lm_setup, max_rel_err):
    _, _, jparams, *_, tparams = lm_setup
    kw = dict(n_uniques=(4, 8, 16, 32), min_size=1024)
    t = tune.tune_params(tparams, budget=tune.TuneBudget(
        max_rel_err=max_rel_err), **kw)
    j = jtune.tune_params(jparams, budget=jtune.TuneBudget(
        max_rel_err=max_rel_err), **kw)
    assert list(t.layers) == list(j.layers)
    for name, a in t.layers.items():
        b = j.layers[name]
        assert a.config.metadata() == b.config.metadata(), name
        if max_rel_err is not None:
            assert abs(a.rel_err - max_rel_err) > 0.01 * max_rel_err
        assert a.rel_err == pytest.approx(b.rel_err, rel=1e-5)
        for f in ("kind", "n_weights", "predicted_bits", "fingerprint",
                  "from_cache"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert a.predicted_sram == pytest.approx(b.predicted_sram, rel=1e-5)
        assert a.predicted_energy_uj == pytest.approx(
            b.predicted_energy_uj, rel=1e-5)
    assert t.meta == j.meta and t.budget.as_dict() == j.budget.as_dict()
    if max_rel_err == 0.15:
        assert len({lp.config.n_unique for lp in t.layers.values()}) == 2


def test_tune_params_refuses_a_tree_without_projections():
    with pytest.raises(ValueError, match="no packable projection"):
        tune.tune_params({"norm": torch.ones(4, 512)})


@pytest.mark.parametrize("direction", ["jax_plan_in_port",
                                       "port_plan_in_jax"])
def test_plans_key_the_other_packages_leaves(lm_setup, tokens, direction):
    """A plan one package's ``tune_params`` made, carried as JSON, keys
    the other package's ``compile_params`` leaf for leaf: the packs take
    the plan's bit widths, and float32 prefill logits agree within
    ``EXP`` with the first package compiling its own plan."""
    jcfg, japi, jparams, tcfg, tapi, tparams = lm_setup
    budget = 0.15
    if direction == "jax_plan_in_port":
        jplan = jtune.tune_params(jparams, n_uniques=(4, 8, 16, 32),
                                  budget=jtune.TuneBudget(max_rel_err=budget))
        tplan = tune.TunePlan.from_json(jplan.to_json())
    else:
        tplan = tune.tune_params(tparams, n_uniques=(4, 8, 16, 32),
                                 budget=tune.TuneBudget(max_rel_err=budget))
        jplan = jtune.TunePlan.from_json(tplan.to_json())
    tcp = codr.compile_params(tparams, plan=tplan, backend="tiled",
                              device="cpu")
    jcp = jcodr.compile_params(jparams, plan=jplan, backend="tiled")
    assert set(tcp.packed_paths) == set(tplan.layers) == set(jcp.packed_paths)
    for path, leaf in tcp.packed_leaves():
        if path in tplan.layers:
            assert leaf.weight.bits == choose_bits(
                tplan.layers[path].config.n_unique)
    assert len({leaf.weight.bits for p, leaf in tcp.packed_leaves()
                if p in tplan.layers}) == 2
    with _f32():
        got, _ = tapi.prefill(tcp.params,
                              {"tokens": torch.from_numpy(tokens)}, tcfg)
        want, _ = japi.prefill(jcp.params, {"tokens": jnp.asarray(tokens)},
                               jcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **EXP)


def test_transformer_quality_smoke():
    q = tune.transformer_quality("qwen2.5-3b", batch=1, prompt_len=4,
                                 device="cpu")
    assert q["n_packed"] > 0
    assert 0.0 <= q["argmax_agreement"] <= 1.0
    assert q["bits_per_weight"] < 16.0
    j = jtune.transformer_quality("qwen2.5-3b", batch=1, prompt_len=4)
    assert set(q) == set(j)
    assert q["n_packed"] == j["n_packed"]
    assert q["bits_per_weight"] == pytest.approx(j["bits_per_weight"],
                                                 rel=0.2)


@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-medium"])
def test_transformer_quality_prefix_models(arch):
    """The prefix-fed models (a vision frontend stub, an encoder-decoder)
    against the reference's ``transformer_quality``: a stub prefix drawn
    beside the tokens, the same keys and packed leaves."""
    q = tune.transformer_quality(arch, batch=1, prompt_len=4, device="cpu")
    j = jtune.transformer_quality(arch, batch=1, prompt_len=4)
    assert set(q) == set(j)
    assert q["n_packed"] == j["n_packed"] > 0
    assert q["bits_per_weight"] == pytest.approx(j["bits_per_weight"],
                                                 rel=0.2)
    assert q["hbm_mb"] == pytest.approx(j["hbm_mb"], rel=0.2)
    assert 0.0 <= q["argmax_agreement"] <= 1.0
    assert np.isfinite(q["mean_abs_logit_err"])


# ---------------------------------------------------------------------------
# deterministic twins of the tests/test_tune_props.py properties
# ---------------------------------------------------------------------------

def test_codr_accesses_monotone_in_tile_counts_det():
    from repro.core import dataflow as jdataflow
    shape = ConvShape(64, 16, 3, 3, 20, 20)
    bits, nu, nn = 5e4, 400.0, 3000.0
    prev = None
    for t_m in (1, 2, 4, 8, 16):
        acc = dataflow.codr_accesses(shape, dataflow.codr_tiling(t_m),
                                     bits, nu, nn)
        jacc = jdataflow.codr_accesses(jdataflow.ConvShape(*dataclasses.astuple(
            shape)), jdataflow.codr_tiling(t_m), bits, nu, nn)
        assert dataclasses.asdict(acc) == dataclasses.asdict(jacc)
        if prev is not None:               # larger t_m -> fewer m-groups
            assert acc.input_sram <= prev.input_sram
            assert acc.output_sram == prev.output_sram
        prev = acc
    small = dataclasses.replace(CODR_TILING, t_ro=4, t_co=4)
    a_big = dataflow.codr_accesses(shape, CODR_TILING, bits, nu, nn)
    a_small = dataflow.codr_accesses(shape, small, bits, nu, nn)
    assert a_small.weight_sram_rows >= a_big.weight_sram_rows


def test_energy_total_is_sum_of_components_det():
    shape = ConvShape(32, 8, 3, 3, 12, 12)
    acc = dataflow.codr_accesses(shape, CODR_TILING, 1e4, 100.0, 500.0)
    e = cost_model.energy(acc)
    assert e.total_uj == pytest.approx(
        e.dram_uj + e.sram_uj + e.rf_uj + e.alu_uj + e.crossbar_uj)


def test_rle_search_never_beats_exhaustive_det(rng):
    from repro.core import rle as jrle
    q = (rng.integers(-8, 8, size=(8, 3, 3, 3)) * 2).astype(np.int8)
    vecs = ucr.layer_ucr_vectors(q, t_m=4, t_n=2)
    vector_len = 4 * 9
    searched = rle.layer_bits_size_only(vecs, vector_len)
    assert searched == jrle.layer_bits_size_only(
        jucr.layer_ucr_vectors(q, t_m=4, t_n=2), vector_len)
    oracle = min(
        rle.layer_bits_size_only(vecs, vector_len, params=p)
        for p in itertools.product(rle.PARAM_SEARCH_SPACE, repeat=3))
    assert oracle <= searched
    # and the search is near-optimal: within one escape header per stream
    assert searched <= oracle + 3 * rle.FULL_BITS
