"""cnn_images_per_s: images of every request completed in the window over
the window's seconds (host clock)."""
from bench.stats import rate


def read(run):
    if "images" not in run.work or not run.work["images"]:
        return None
    return rate(run.work["images"], run.window_s)
