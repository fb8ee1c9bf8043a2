"""One intra-op thread for torch in a test process of the port's suite.

The suite runs under pytest-xdist, six worker processes on a machine of
eight cores. torch's intra-op pool has a thread per core in each worker,
and OpenMP's barriers under that oversubscription slow the port's small
CPU programs by two orders of magnitude: the early-stopped DP round test
of ``test_torch_round_features.py`` takes 2.4 s alone and 600 s beside five
copies of itself, 3.4 s beside them with one thread each. Every
``tests/test_torch_*.py`` module imports this module first; the JAX
package's tests do not use torch and XLA keeps its own pool."""

import torch

torch.set_num_threads(1)
