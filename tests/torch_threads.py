"""The port's tests run torch on one thread.

Every ``tests/test_torch_*.py`` imports ``_one_torch_thread`` into its
namespace, where pytest finds it and applies it to each of the module's
tests (``tests/test_torch_inventory.py`` checks that each does, and that
none keeps a copy of its own). ``tests/torch_mesh_worker.py`` pins its own
process.

Why: the CPU build of torch can return one worker's chunk of its first
multi-threaded ``torch.sqrt`` at low accuracy (ROADMAP.md Queue 3), and
under ``pytest -n`` a module whose torch spins a thread for every core
takes those cores from the other workers' modules.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The CPU build of torch can return one worker's chunk of its first
    # multi-threaded torch.sqrt at ~3e-4 relative error; plain torch does it
    # without jax (ROADMAP.md Queue 3). Torch runs on the calling thread only.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
