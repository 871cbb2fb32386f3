"""The range router's lane balance over the traced slice: (most - fewest)
entries routed to a lane, as a share of the most, from the program's
device profile (``lane_entries``). Nothing to read on one resolver."""


def read(ctx):
    lanes = ctx.profile.get("lane_entries") or []
    if len(lanes) < 2 or max(lanes) <= 0:
        return None
    return 100.0 * (max(lanes) - min(lanes)) / max(lanes)
