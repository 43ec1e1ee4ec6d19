"""Frames of the scenes or sequences completed in the window over the
seconds those scenes took: all the work over all the time."""


def read(rec: dict) -> float:
    scenes = rec["scenes"]
    return (sum(s["frames"] for s in scenes)
            / sum(s["seconds"] for s in scenes))
