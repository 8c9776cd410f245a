"""% of the window outside the steps' device time: 1 − (device ms of the
steps run) / window wall; the trainer's, the dispatch's and the data
pipeline's share (moves train_img_per_s)."""


def read(ctx):
    if not ctx.get("steps_device_s") or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["steps_device_s"] / ctx["window_s"])
