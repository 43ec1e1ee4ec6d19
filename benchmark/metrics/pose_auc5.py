"""Mean over the window's scenes of the AUC@5 of relative poses against
the planted cameras (thresholds 1..5 degrees, each frame pair scored by
max(rotation error, translation-direction error))."""


def read(rec: dict) -> float:
    scenes = rec["scenes"]
    return sum(s["auc5"] for s in scenes) / len(scenes)
