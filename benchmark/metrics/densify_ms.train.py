"""Wall ms a densify event in the window: the densify step, the 3D filter
and the KNN refresh, ended by a synchronize."""


def read(ctx):
    d = ctx["window"]["densify_ms"]
    return sum(d) / len(d) if d else None
