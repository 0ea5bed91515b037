"""Episodes a second the window trained: B x the game steps it completed, over its seconds
on the host clock, which end at a synchronize after its last step.  Also the reader of
``train_episodes_per_s.<suffix>``, the same rate in cells held to a bound of their own."""

UNIT = "episodes/s"


def read(ctx):
    w = ctx.get("window")
    return w["batch_size"] * w["steps"] / w["seconds"] if w and w["seconds"] > 0 else None
