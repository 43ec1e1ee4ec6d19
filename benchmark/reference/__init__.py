"""The plain reference the check holds the program against: frozen copies
of the port's models (`tracker`, `refine`, `encoders`, `layers`,
`embeddings`, `sampling`, `camera`, `dinov2`, `aliked`), with every
hand-written kernel replaced by its plain PyTorch version (`plain_ops`),
the ALIKED keypoint selection (`keypoints`), and the control's
lower-precision products (`precision`). Run in float32 with TF32 off.

Nothing here imports the port or the JAX package: a change to the program
does not change its reference. The copies keep the port's module
docstrings, which name the modules they mirror.
"""
