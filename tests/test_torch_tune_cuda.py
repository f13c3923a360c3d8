"""Tuned plans on the card (``cuda`` marker; they skip without one: a
CUDA kernel has no CPU mode, and the CPU runs the plain versions, which
``tests/test_torch_tune.py`` holds against the reference).  No JAX is
imported, so the file runs on a machine with the card alone:

    python -m pytest -q --noconftest -m cuda tests/test_torch_tune_cuda.py

* a tuned 2-layer VGG16 plan (per-layer U and ``t_m``) through
  ``smm_kernel``: every layer's ``smm_conv`` launch equals its plain
  version and the model equals the plain-``smm_conv`` lane (``smm``),
  max-abs-diff 0;
* a smoke qwen2.5-3b whose plan mixes 2-, 4- and 8-bit leaves through
  ``codr_matmul``: float32 logits within ``0.02 · max(|tiled|, 1)`` of
  the same packs on ``tiled`` (the lane bound of ``chip_smoke.py``), and
  the captured decode step replays to the eager loop's tokens and
  logits bits.
"""
import numpy as np
import pytest
import torch

import repro_torch.api as codr
from repro_torch import tune
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import get_model
from repro_torch.models import lm as tlm


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (smm_conv and codr_matmul are "
                    "CUDA kernels with no CPU mode; the CPU runs their "
                    "plain versions)")


@pytest.mark.cuda
def test_cuda_tuned_vgg16_on_smm_kernel_equals_plain_smm_conv():
    """A tuned plan over VGG16's first two layers (per-layer U and t_m)
    through ``smm_kernel``: every layer's kernel equals its plain
    version, and the model equals the plain-``smm_conv`` lane (the
    ``smm`` backend) at max-abs-diff 0."""
    _card()
    from repro_torch.core.backends import _int_activations
    from repro_torch.kernels.smm_conv import ops, ref
    hw = (36, 36)
    spec = codr.ModelSpec.from_paper_cnn(
        "vgg16", n_conv=2, n_out=None, ri=hw[0], ci=hw[1], density=0.4,
        rng=np.random.default_rng(0))
    plan = tune.tune_spec(spec, hw, budget=tune.TuneBudget(max_rel_err=0.05),
                          grid=tune.TuneGrid(max_vectors=None,
                                             n_uniques=(16, 64, 256)))
    compiled = codr.compile(spec, plan=plan, backend="smm_kernel")
    x = np.random.default_rng(1).integers(0, 256, size=(2, *hw, 3)).astype(
        np.float32)
    before = ops.launches
    y = compiled.run(x)
    assert ops.launches - before == len(spec)
    assert torch.equal(y, compiled.run(x, backend="smm"))
    h = compiled.model.as_input(x)
    ri, ci = hw
    for layer in compiled.model.layers:
        deltas, entries, meta = layer.smm_operands()
        ro, co = layer.out_hw(ri, ci)
        xi, _ = _int_activations(h)
        xin = xi.permute(0, 3, 1, 2).contiguous()
        kw = dict(t_m=meta["t_m"], ro=ro, co=co, stride=layer.stride)
        got = ops.smm_conv_cuda(xin, deltas, entries,
                                int8_weights=meta["int8_weights"], **kw)
        assert torch.equal(got, ref.smm_conv_plain(xin, deltas, entries,
                                                   **kw)), layer.name
        h = compiled.backend.conv(layer, h)
        ri, ci = ro, co


def _mixed_plan(params) -> dict:
    """2-, 4- and 8-bit leaves: U = 4, 16 and 256 in turn over the
    projection leaves."""
    paths = [p for p, leaf in leaves_with_path(params)
             if "proj" in p and leaf.dim() >= 2]
    return {p: codr.EncodeConfig(n_unique=(4, 16, 256)[i % 3])
            for i, p in enumerate(paths)}


@pytest.mark.cuda
def test_cuda_mixed_bit_plan_on_codr_matmul_within_the_lane_bound():
    """A smoke qwen2.5-3b with 2-, 4- and 8-bit leaves through
    ``codr_matmul`` (float32 activations) within ``0.02 · max(|tiled|,
    1)`` of the same packs on ``tiled``; greedy decode replayed from the
    captured step equals the eager loop bit for bit."""
    _card()
    from repro_torch.launch.serve import greedy_decode
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    api = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init_params(gen, cfg)
    plan = _mixed_plan(params)
    cp = codr.compile_params(params, plan=plan, backend="codr_matmul")
    bits = {leaf.weight.bits for p, leaf in cp.packed_leaves() if p in plan}
    assert bits == {2, 4, 8}
    tiled = codr.compile_params(params, plan=plan, backend="tiled")
    tokens = torch.randint(0, cfg.vocab_size, (4, 6), generator=gen,
                           device="cuda")
    saved = tlm.DEFAULT_DTYPE
    tlm.DEFAULT_DTYPE = torch.float32
    try:
        a, _ = api.prefill(cp.params, {"tokens": tokens}, cfg)
        b, _ = api.prefill(tiled.params, {"tokens": tokens}, cfg)
    finally:
        tlm.DEFAULT_DTYPE = saved
    assert float((a - b).abs().max()) <= 0.02 * max(float(b.abs().max()),
                                                    1.0)
    g_eager, _, _ = greedy_decode(api, cp.params, tokens, cfg, 5, eager=True)
    g_replay, _, _ = greedy_decode(api, cp.params, tokens, cfg, 5)
    assert torch.equal(g_eager, g_replay)
    # every step's logits, the captured step against decode_step
    caches = [api.init_cache(cfg, 4, 8, device="cuda") for _ in range(2)]
    step = tlm.CapturedDecode(cp.params, caches[1], cfg, 4)
    for i in range(7):
        want, caches[0] = api.decode_step(cp.params, caches[0],
                                          tokens[:, i % 6], i, cfg)
        assert torch.equal(step(tokens[:, i % 6], i), want), f"step {i}"
