"""Device ms of one step without R1 (a lazy window's tail): its CUDA graph
replayed back to back (moves train_img_per_s)."""


def read(ctx):
    return ctx.get("device_ms", {}).get("plain")
