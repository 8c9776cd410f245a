"""GiB the process holds on the card over the window: `max_memory_reserved`,
reset at the window's start (it counts the CUDA graphs' pools, whose
replays the allocated peak does not see)."""


def read(ctx):
    if not ctx.get("on_card") or not ctx.get("peak_window_bytes"):
        return None
    return ctx["peak_window_bytes"] / 2 ** 30
