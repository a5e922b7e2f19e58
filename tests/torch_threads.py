"""One torch thread for the tests of a module that imports ``one_thread``.

Tier-1 runs six pytest workers on the CPU's cores. Each torch process
asks OpenMP for one thread a core, so beside five busy workers every
parallel region of a small tensor op waits on threads that get no core:
``test_torch_port_cli.py``'s ``[unfrozen-blur]`` case took 141 s beside
six busy processes with torch's default threads and 40 s with one (9 s
on an idle machine). The modules that import this fixture run their
torch code on one thread and give the count back when they end.

Only modules whose checks hold at any thread count take it: a sum in
another order moves MobileNetV2's ill-conditioned gradients past
``test_torch_port_backbones.py``'s limits, so that module keeps the
default.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
