"""DBSCAN's label iterations a step over the window, from the program's
counter ``dbscan_cluster_means.iterations`` (each four cost a host
sync)."""

LAYER = "junction proposals (assignment/clustering.py)"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "step_ms_p90"


def read(ctx):
    if not ctx["dbscan_iterations"]:
        return None
    return ctx["dbscan_iterations"] / ctx["window_steps"]
