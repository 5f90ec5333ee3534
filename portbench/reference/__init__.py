"""The benchmark's plain reference: the configurations' models, losses and
optimizer in eager PyTorch, float32, with no kernel, cache or batching of the
program under test.  Nothing here imports the program.

Each configuration has a module of its own, ``reference/<config>.py``, found
by name; :mod:`portbench.reference.common` holds what they share.  A model
is a dict of named tensors (the names of the program's ``state_dict``),
handed over by the benchmark, which made the weights from the seed.
"""
