"""Host milliseconds of the cell SOM's training and assignment in one job
(device ops): the `cells.som_train` and `cells.som_assign` spans of
`CellSOMCluster` in the job the driver runs after the traced window with
the spans recorded and no profiler (the profiler's cost on the training's
eager launches about doubles them inside the window)."""


def read(rec):
    return rec.get("som_ms_untraced")
