"""One PyTorch intra-op thread in each test process.

The repository's test command runs six pytest-xdist workers on the
machine's cores.  PyTorch's default pool of one thread a core in each of
them oversubscribes the cores, and their waiting threads spin: six copies
of a float64 gradient test side by side took 472 s at the default and 56 s
at one thread each.  Every worker imports every test module while it
collects, so the port's test files import this module, and the setting
holds for the whole run.  Tests that hold two computations to each other
run both in one process, so both see the same setting.
"""
import torch

torch.set_num_threads(1)
