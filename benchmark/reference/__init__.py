"""The benchmark's plain reference: plain PyTorch on any device, imports
nothing of the program (`ed3dgs_torch`) nor JAX.

Its modules are frozen copies of the port's plain versions (the `*_plain`
functions the program runs on a CPU tensor, and `knn_plain`), cut to one
device and the main path, so that a later change to the program cannot move
the yardstick; `step` assembles the training step and the served frame from
them.
"""
