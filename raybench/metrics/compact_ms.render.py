"""compact_ms.render: device ms a step of the kernels launched inside the
program's blink.compact ranges and no range nested in them: li_path's
compaction sort, its index_selects and the final inverse gather."""
from raybench.lib import spans


def read(ctx):
    return spans.stage_ms(ctx, "compact")
