"""GoogLeNet's inception modules on the port's CNN lanes: branch modules,
SAME padding and max pooling in ``ModelSpec`` / ``compile`` /
``CompiledModel.run``, held to the plain reference
(``repro_torch.models.inception_ref``) at a small size on the CPU, and on
a card the CUDA path to the CPU plain version bit for bit.

    python -m pytest -q --noconftest -m cuda tests/test_torch_inception.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import repro_torch.api as codr
from repro_torch.configs.paper_cnns import GOOGLENET_INCEPTION
from repro_torch.core import backends, spans
from repro_torch.core.engine import MaxPool2D
from repro_torch.kernels.int8_features import ref as feats_ref
from repro_torch.models import inception_ref as R

INT_LANES = ("smm", "smm_kernel")
# a small module: C_in 24 at 10², branch widths 8 / 8→16 / 4→8 / 8
SMALL = (24, 8, 8, 16, 4, 8, 8)
SMALL2 = (40, 8, 8, 16, 4, 8, 8)      # the next module: 8 + 16 + 8 + 8 in
# tiled against the float64 reference: float32 sums in another order,
# over at most four convolutions in a row; the same bound as the VGG
# cell's tiny-size check (its limit 1e-4 over ten)
TILED_REL = 1e-5


@pytest.fixture(autouse=True)
def _empty_spans():
    spans.clear()
    yield
    spans.clear()


def _weights(g, cin, c1, c3r, c3, c5r, c5, pp):
    """The six ``(weight, bias)`` pairs of a module: paper-style sparse
    Gaussian weights (density 0.4, scale 0.5) and Gaussian biases."""
    out = []
    for m, n, k in ((c1, cin, 1), (c3r, cin, 1), (c3, c3r, 3),
                    (c5r, cin, 1), (c5, c5r, 5), (pp, cin, 1)):
        w = torch.randn(m, n, k, k, generator=g) * 0.5
        w[torch.rand(w.shape, generator=g) > 0.4] = 0
        out.append((w, torch.randn(m, generator=g) * 0.5))
    return out


def _module_spec(ws, name):
    pads = (0, 0, 1, 0, 2, 0)
    c = [codr.LayerSpec.conv(w.numpy(), b.numpy(), padding=p,
                             activation="relu", name=f"{name}.{i}")
         for i, ((w, b), p) in enumerate(zip(ws, pads))]
    return codr.ModuleSpec(([c[0]], [c[1], c[2]], [c[3], c[4]],
                            [codr.PoolSpec(3, 1, 1), c[5]]), name=name)


def _net(kind: str, seed: int = 0):
    """``(ModelSpec, reference steps, input)``: one module, or two with a
    3×3/2 ceil-mode pooling between them."""
    g = torch.Generator().manual_seed(seed)
    w1 = _weights(g, *SMALL)
    spec, steps = [_module_spec(w1, "3a")], [R.inception_module(*w1)]
    if kind == "stack":
        w2 = _weights(g, *SMALL2)
        spec += [codr.PoolSpec(3, 2, 0, True), _module_spec(w2, "3b")]
        steps += [R.Pool(3, 2, 0, True), R.inception_module(*w2)]
    x = torch.relu(torch.randn(2, 10, 10, 24, generator=g))
    return codr.ModelSpec(spec), steps, x


def _compile(spec, lane):
    return codr.compile(spec, codr.EncodeConfig(n_unique=16), backend=lane,
                        device="cpu")


def _rel(y, want):
    return float((y.double() - want).abs().max() / want.abs().max())


# -- against the reference ----------------------------------------------------

@pytest.mark.parametrize("kind", ["module", "stack"])
@pytest.mark.parametrize("lane", ["tiled", "smm", "smm_kernel"])
def test_inception_matches_the_plain_reference(lane, kind):
    """The integer lanes are the reference's int8 arithmetic bit for bit
    (exact sums, the same roundings); ``tiled`` within ``TILED_REL``."""
    spec, steps, x = _net(kind)
    y = _compile(spec, lane).run(x)
    want = R.forward(steps, x, lane=lane)
    hw = 10 if kind == "module" else 5
    assert y.shape == want.shape == (2, hw, hw, 40)
    if lane in INT_LANES:
        assert torch.equal(y.double(), want)
    else:
        assert _rel(y, want) <= TILED_REL


@pytest.mark.parametrize("mesh", [1, 2])
def test_sharded_runs_modules_bit_for_bit_tiled(mesh):
    spec, _, x = _net("stack")
    be = backends.ShardedBackend((torch.device("cpu"),) * mesh)
    assert be.supports_model(spec.layers) == (True, "")
    compiled = _compile(spec, "tiled")
    assert torch.equal(compiled.run(x, backend=be), compiled.run(x))


def test_the_oracles_walk_modules():
    spec, steps, x = _net("stack")
    compiled = _compile(spec, "tiled")
    y = compiled.run(x)
    assert _rel(compiled.quantized_reference(x), y.double()) <= TILED_REL
    assert compiled.reference(x).shape == y.shape


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("lane", ["tiled", "smm", "smm_kernel"])
@pytest.mark.parametrize("pad", [1, 2])
def test_padding_equals_f_pad_then_valid(lane, pad):
    g = torch.Generator().manual_seed(pad)
    k = 2 * pad + 1
    w = (torch.randn(6, 5, k, k, generator=g) * 0.5).numpy()
    x = torch.relu(torch.randn(2, 7, 9, 5, generator=g))

    def one(p):
        return _compile(codr.ModelSpec([codr.LayerSpec.conv(
            w, padding=p, activation="relu", name="c")]), lane)
    y = one(pad).run(x)
    assert y.shape == (2, 7, 9, 6)
    assert torch.equal(y, one(0).run(F.pad(x, (0, 0, pad, pad, pad, pad))))


@pytest.mark.parametrize("kind", ["relu_out", "whole"])
def test_pooled_int8_features_equal_the_quantized_pooled_tensor(kind):
    """``x`` ≥ 0: the pooling keeps amax and rounding is monotone, so
    pooling the features at ``x``'s scale is quantizing the pooled
    tensor."""
    g = torch.Generator().manual_seed(3)
    x = torch.relu(torch.randn(3, 9, 8, 6, generator=g)) * 40
    if kind == "whole":
        x = torch.round(x) + 128          # whole, beyond ±127
    pool = MaxPool2D(3, 1, 1)
    q, s = feats_ref.int8_features_plain(x)
    pq, ps = feats_ref.int8_features_plain(pool(x))
    assert torch.equal(s, ps) and torch.equal(pool.pool_nchw(q), pq)


@pytest.mark.parametrize("args", [(3, 1, 1, False), (3, 2, 0, True),
                                  (3, 2, 0, False), (2, 2, 0, False),
                                  (3, 2, 1, True)])
@pytest.mark.parametrize("hw", [(28, 28), (14, 13), (7, 8)])
def test_pool_out_hw_is_max_pool2ds(args, hw):
    pool = MaxPool2D(*args)
    y = pool(torch.zeros(1, *hw, 2))
    assert y.shape[1:3] == pool.out_hw(*hw)


@pytest.mark.parametrize("lane", ["tiled", "smm", "smm_kernel"])
def test_branches_concatenate_in_declared_order(lane):
    """Each branch alone, as a model of its own steps, gives its slice of
    the module's output channels, in declared order."""
    spec, _, x = _net("module")
    y = _compile(spec, lane).run(x)
    c0 = 0
    for branch in spec.steps[0].branches:
        alone = _compile(codr.ModelSpec(list(branch)), lane).run(x)
        m = alone.shape[-1]
        assert torch.equal(y[..., c0:c0 + m], alone)
        c0 += m
    assert c0 == y.shape[-1] == 40


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return spans.spans()


@pytest.mark.parametrize("lane", INT_LANES)
def test_each_distinct_module_input_is_quantized_once(lane):
    """Three feature paths a module: its input (shared by the three 1×1
    convolutions and the pool branch), and each reduce's output."""
    spec, _, x = _net("stack")
    compiled = _compile(spec, lane)
    got = _profiled(lambda: compiled.run(x))
    names = [s.name for s in got]
    assert names.count("codr.features") == 6
    assert names.count("codr.layer") == 12
    assert names.count("codr.module") == 2
    branches = [s for s in got if s.name == "codr.branch"]
    assert [(s.attrs["module"], s.attrs["index"], s.attrs["kind"])
            for s in sorted(branches, key=lambda s: s.start_ns)] == [
        (m, i, k) for m in ("3a", "3b")
        for i, k in enumerate(("1x1", "3x3", "5x5", "pool"))]
    pools = [s.attrs for s in got if s.name == "codr.pool"]
    assert sorted((p["window"], p["stride"]) for p in pools) == \
        [(3, 1), (3, 1), (3, 2)]
    by_id = {s.id: s for s in got}
    feats = [s for s in got if s.name == "codr.features"]
    # the module input's features are made inside its first branch
    assert all(by_id[f.parent].name in ("codr.branch", "codr.layer")
               for f in feats)


def test_a_vgg_chain_through_the_extended_spec_is_what_it_was():
    """A plain list of VALID layers is one step a layer: the same numbers
    as chaining the lane's own ``conv`` by hand, on every lane, and the
    same with ``padding=0`` spelled out."""
    g = torch.Generator().manual_seed(9)
    ws = [(torch.randn(m, n, 3, 3, generator=g) * 0.5).numpy()
          for m, n in ((4, 3), (8, 4), (8, 8))]
    x = torch.randint(0, 256, (2, 12, 12, 3), generator=g).float()
    for lane in ("tiled", "smm", "smm_kernel", "sharded"):
        plain = _compile(codr.ModelSpec([codr.LayerSpec.conv(
            w, activation="relu", name=f"c{i}")
            for i, w in enumerate(ws)]), lane)
        spelled = _compile(codr.ModelSpec([codr.LayerSpec.conv(
            w, padding=0, activation="relu", name=f"c{i}")
            for i, w in enumerate(ws)]), lane)
        assert plain.model.steps == plain.model.layers
        be, h = backends.get_backend(lane), x
        for layer in plain.model.layers:
            h = be.conv(layer, h)
        assert torch.equal(plain.run(x), h)
        assert torch.equal(spelled.run(x), h)


# -- the spec -----------------------------------------------------------------

def test_spec_lists_every_layer_and_checks_channels():
    spec, _, _ = _net("stack")
    assert len(spec.steps) == 3 and len(spec) == len(spec.layers) == 12
    assert [ls.name for ls in spec.layers[:6]] == [
        f"3a.{i}" for i in (0, 1, 2, 3, 4, 5)]
    g = torch.Generator().manual_seed(1)
    bad = _weights(g, 32, *SMALL2[1:])          # 32 in, 40 come
    with pytest.raises(ValueError, match="input channels"):
        codr.ModelSpec([spec.steps[0], _module_spec(bad, "3b")])
    w = np.ones((4, 24, 1, 1), np.float32)
    with pytest.raises(ValueError, match="end with a conv"):
        codr.ModuleSpec(([codr.LayerSpec.conv(w), codr.PoolSpec(3, 1, 1)],))
    with pytest.raises(ValueError, match="padding"):
        codr.LayerSpec("linear", np.ones((3, 4), np.float32), padding=1)


def test_paper_table_chains_module_to_module():
    mods = list(GOOGLENET_INCEPTION.values())
    for (hw, _, c1, _, c3, _, c5, pp), nxt in zip(mods, mods[1:]):
        assert c1 + c3 + c5 + pp == nxt[1]
        assert nxt[0] in (hw, -(-(hw - 3) // 2) + 1)
    assert [m[0] for m in mods] == [28, 28, 14, 14, 14, 14, 14, 7, 7]
    assert sum(mods[-1][i] for i in (2, 4, 6, 7)) == 1024


def test_stats_and_sram_report_walk_modules():
    """Modules 3a and 3b of Table 1 at an eighth of their widths: every
    layer's stats, and its SRAM estimate on its bordered plane."""
    g = torch.Generator().manual_seed(2)
    steps = []
    for name in ("3a", "3b"):
        hw, *widths = GOOGLENET_INCEPTION[name]
        steps.append(_module_spec(_weights(g, *(w // 8 for w in widths)),
                                  name))
    compiled = _compile(codr.ModelSpec(steps), "tiled")
    stats = compiled.stats()
    assert [s.name for s in stats] == [ls.name for ls in
                                       compiled.spec.layers]
    report = compiled.sram_report((hw, hw))
    assert [n for n, _ in report] == [s.name for s in stats]
    shapes = [s for _, s in compiled.model.layer_shapes((hw, hw))]
    assert [(s.rk, s.ri) for s in shapes[:6]] == [
        (1, 28), (1, 28), (3, 30), (1, 28), (5, 32), (1, 28)]
    assert all(a.mults > 0 for _, a in report)
    compiled.verify_roundtrip()
    assert compiled.total_bits() == sum(s.encoded_bits for s in stats)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["module", "stack"])
def test_cuda_path_equals_the_cpu_plain_version(cuda_device, kind):
    """``smm_kernel`` on the card: the ``int8_features`` kernels (the
    padded quantize, the max pooling of the int8 features and between the
    modules) and ``smm_conv`` with the epilogue in its store (into a
    channel slice at each branch's end), bit for bit the CPU's plain
    version, no read to the host, six ``smm_conv`` launches a module, all
    ``sm90`` and all with the epilogue, no separate epilogue launch; the
    second module's four readers of its input (NCHW storage: raw
    features) quantize in phase 1b, and no flat quantize launches."""
    from repro_torch.kernels.int8_features import ops as feats
    from repro_torch.kernels.smm_conv import ops as smm_ops
    spec, _, x = _net(kind)
    want = _compile(spec, "smm_kernel").run(x)
    card = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                        backend="smm_kernel", device=cuda_device)
    card.run(x)                          # decode and pack once
    torch.cuda.synchronize()
    smm_ops.launches_by_impl.update(dict.fromkeys(smm_ops.IMPLS, 0))
    feats.launches_by_impl.update(dict.fromkeys(feats.IMPLS, 0))
    with_epilogue = smm_ops.launches_with_epilogue
    with_quantize = smm_ops.launches_with_quantize
    got = _profiled(lambda: card.run(x))
    y = card.run(x).cpu()
    n_mod = 1 if kind == "module" else 2
    assert torch.equal(y, want)
    assert not [s for s in got if s.name == "codr.host_read"]
    assert smm_ops.launches_by_impl == {"sm90": 12 * n_mod, "simt": 0}
    assert smm_ops.launches_with_epilogue - with_epilogue == 12 * n_mod
    assert smm_ops.launches_with_quantize - with_quantize == 8 * (n_mod - 1)
    assert feats.launches_by_impl["quantize"] == 0
    assert feats.launches_by_impl["stats"] == 6 * n_mod
    assert feats.launches_by_impl["quantize_pad"] == 4 * n_mod
    assert feats.launches_by_impl["epilogue"] == 0
    assert feats.launches_by_impl["max_pool"] == 2 * (2 * n_mod - 1)


def _googlenet(device):
    """Inception 3a, 3b, the 3×3/2 pool, 4a, 4b at their published widths
    (``GOOGLENET_INCEPTION``; weights as :func:`_weights`) on
    ``smm_kernel``: 24 convolutions."""
    g = torch.Generator().manual_seed(11)
    steps = []
    for name in ("3a", "3b", "4a", "4b"):
        if name == "4a":
            steps.append(codr.PoolSpec(3, 2, 0, True))
        steps.append(_module_spec(_weights(g, *GOOGLENET_INCEPTION[name][1:]),
                                  name))
    return codr.compile(codr.ModelSpec(steps), codr.EncodeConfig(n_unique=16),
                        backend="smm_kernel", device=device)


@pytest.fixture(scope="module")
def googlenet_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return _googlenet("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["3a", "3b", "4a", "4b"])
def test_cuda_fused_store_equals_smm_conv_then_epilogue_googlenet(
        name, googlenet_card):
    """At each of a module's six convolutions (batch 2, the published
    plane, on its border): the sm90 launch with the epilogue in its store
    is ``torch.equal`` to ``smm_conv`` then the ``int8_features``
    epilogue, each branch's last convolution into its channel slice of
    the module's output with the other channels untouched; one sm90
    launch each, counted with the epilogue, no separate epilogue.  At the
    four readers of the module's input (the three 1×1 convolutions on it,
    pool proj on its max pooling) on raw features, as after 3a: the
    launch that quantizes them in phase 1b is ``torch.equal`` to the
    ``int8_features`` quantize then ``smm_conv``, and pooling the raw
    features then quantizing is the quantized features pooled."""
    from repro_torch.kernels.int8_features import ops as feats
    from repro_torch.kernels.smm_conv import ops as smm_ops
    mod = next(s for s in googlenet_card.model.steps
               if s.kind == "module" and s.name == name)
    hw = GOOGLENET_INCEPTION[name][0]
    gen = torch.Generator(device="cuda").manual_seed(len(name))
    scale = torch.tensor([0.0173], device="cuda")
    raw = torch.relu(torch.randn(2, GOOGLENET_INCEPTION[name][1], hw, hw,
                                 device="cuda", generator=gen)) * 30
    raw_scale = feats.feature_scale(raw.permute(0, 2, 3, 1))
    pooled = feats.max_pool(raw, 3, 1, 1)
    assert torch.equal(
        feats.quantize(pooled.permute(0, 2, 3, 1), raw_scale),
        feats.max_pool(feats.quantize(raw.permute(0, 2, 3, 1), raw_scale),
                       3, 1, 1))
    c0 = 0
    for branch in mod.branches:
        reader = next(s for s in branch if s.kind == "conv")
        m = reader.code.shape[0]
        width, at = ((mod.out_channels, c0) if reader is branch[-1]
                     else (m, 0))
        inp = pooled if branch[0].kind == "pool" else raw
        bufs = [torch.full((2, width, hw, hw), 7.0, device="cuda")
                for _ in range(2)]
        kw = dict(operands=reader.smm_operands(), x_scale=raw_scale,
                  layer_scale=reader.scale, bias=reader.bias_device,
                  relu=True)
        smm_ops.smm_conv_batched(
            feats.quantize(inp.permute(0, 2, 3, 1), raw_scale), reader.code,
            out=bufs[0][:, at:at + m], **kw)
        before = (smm_ops.launches_by_impl["sm90"],
                  smm_ops.launches_with_quantize,
                  feats.launches_by_impl["quantize"])
        smm_ops.smm_conv_batched(inp, reader.code, raw_features=True,
                                 out=bufs[1][:, at:at + m], **kw)
        torch.cuda.synchronize()
        assert torch.equal(bufs[0], bufs[1]), (name, reader.name)
        assert (smm_ops.launches_by_impl["sm90"] - before[0],
                smm_ops.launches_with_quantize - before[1],
                feats.launches_by_impl["quantize"] - before[2]) == (1, 1, 0)
        c0 += branch[-1].code.shape[0]
    c0 = 0
    for branch in mod.branches:
        for layer in (s for s in branch if s.kind == "conv"):
            m, n = layer.code.shape[:2]
            last = layer is branch[-1]
            ri = hw + 2 * layer.padding
            q = torch.randint(-127, 128, (2, n, ri, ri), device="cuda",
                              generator=gen).float()
            width, at = (mod.out_channels, c0) if last else (m, 0)
            bufs = [torch.full((2, width, hw, hw), 7.0, device="cuda")
                    for _ in range(2)]
            y = smm_ops.smm_conv_batched(q, layer.code,
                                         operands=layer.smm_operands())
            feats.epilogue(y, scale, layer.scale, layer.bias_device,
                           relu=True, out=bufs[0][:, at:at + m])
            before = (smm_ops.launches_by_impl["sm90"],
                      smm_ops.launches_with_epilogue,
                      feats.launches_by_impl["epilogue"])
            smm_ops.smm_conv_batched(q, layer.code,
                                     operands=layer.smm_operands(),
                                     x_scale=scale, layer_scale=layer.scale,
                                     bias=layer.bias_device, relu=True,
                                     out=bufs[1][:, at:at + m])
            torch.cuda.synchronize()
            assert torch.equal(bufs[0], bufs[1]), (name, layer.name)
            assert (smm_ops.launches_by_impl["sm90"] - before[0],
                    smm_ops.launches_with_epilogue - before[1],
                    feats.launches_by_impl["epilogue"] - before[2]) == (1, 1,
                                                                        0)
        c0 += branch[-1].code.shape[0]


@pytest.mark.cuda
def test_cuda_googlenet_forward_applies_every_epilogue_in_the_store(
        googlenet_card):
    """A forward of the four modules: 24 sm90 launches, each with the
    epilogue in its store, and no ``int8_features`` epilogue launch; 3a's
    input NHWC-contiguous (``quantize_nhwc``), the inputs of 3b, 4a and
    4b a layer's output or its pooling (NCHW storage), whose four readers
    each quantize them in phase 1b: 12 of the 24, no flat quantize
    launch."""
    from repro_torch.kernels.int8_features import ops as feats
    from repro_torch.kernels.smm_conv import ops as smm_ops
    x = torch.relu(torch.randn(2, 28, 28, 192, device="cuda"))
    googlenet_card.run(x)                    # decode and pack once
    torch.cuda.synchronize()
    before = (dict(smm_ops.launches_by_impl), smm_ops.launches_with_epilogue,
              dict(feats.launches_by_impl), smm_ops.launches_with_quantize)
    y = googlenet_card.run(x)
    torch.cuda.synchronize()
    assert y.shape == (2, 14, 14, 512)
    assert {i: smm_ops.launches_by_impl[i] - before[0][i]
            for i in smm_ops.IMPLS} == {"sm90": 24, "simt": 0}
    assert smm_ops.launches_with_epilogue - before[1] == 24
    assert smm_ops.launches_with_quantize - before[3] == 12
    assert {i: feats.launches_by_impl[i] - before[2][i]
            for i in feats.IMPLS} == {
        "stats": 12, "quantize": 0, "quantize_nhwc": 1, "quantize_pad": 8,
        "max_pool": 5, "epilogue": 0}
