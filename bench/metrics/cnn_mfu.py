"""cnn_mfu: percent of the lane's peak that the whole request reached:
2 × nonzero weights × output positions, summed over the layers, × images
completed, over the window's seconds, over the peak of the lane's
arithmetic (the cell's ``arithmetic``: int8 for ``smm_kernel``, fp32 for
``tiled``)."""
from bench.roofline import PEAK_OPS, conv_nonzero_ops, conv_out_hw


def read(run):
    shapes = run.shapes
    if not shapes.get("layers") or not run.work.get("images"):
        return None
    ops_per_image = 0.0
    for layer, nz in zip(shapes["layers"], shapes["nonzero"]):
        ro, co = conv_out_hw(layer["ri"], layer["ci"], layer["rk"],
                             layer["ck"], layer["stride"])
        ops_per_image += conv_nonzero_ops(nz, ro, co, 1)
    ops = ops_per_image * run.work["images"]
    return 100.0 * ops / run.window_s / PEAK_OPS[shapes["arithmetic"]]
