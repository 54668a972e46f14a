"""blas_entries.tlas: BLAS walks begun a live lane of the two-level walk
(the program's blas_entries.* over walk_live.* counters of the traced
stretches): the work instancing adds over the flat tree."""
from raybench.lib import tlaswork


def read(ctx):
    return tlaswork.entries_per_live_lane()
