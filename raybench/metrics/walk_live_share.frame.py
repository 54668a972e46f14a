"""walk_live_share.frame: live lanes (closest hit: its alive lanes; any hit:
t_far > 0) over the lanes the walks were launched over, in %, from the
program's walk_live.* and walk_lanes.* counters of the traced stretches."""
from raybench.lib import spans


def read(ctx):
    return spans.walk_live_share()
