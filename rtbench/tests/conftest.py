import torch

# The CPU runs of the tests are timed windows: one thread a worker keeps
# parallel workers from starving each other's frames.
torch.set_num_threads(1)
