"""The auction's rounds a step over the window, both assignments, from
the program's counter ``auction_assignment.rounds`` (each round is some
twenty small launches, a host check every sixteen)."""

LAYER = "junction assignment (assignment/matching.py)"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "train_rays_per_sec"


def read(ctx):
    if not ctx["auction_rounds"]:
        return None
    return ctx["auction_rounds"] / ctx["window_steps"]
