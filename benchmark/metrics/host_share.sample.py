"""% of a request that is not G's forward on the device: 1 − forward_ms /
mean request ms (latents, finite check, denorm, copy to the host, and the
host's launches; moves sample_p95_ms)."""


def read(ctx):
    forward = ctx.get("device_ms", {}).get("forward")
    if forward is None or not ctx.get("mean_request_ms"):
        return None
    return 100.0 * (1.0 - forward / ctx["mean_request_ms"])
