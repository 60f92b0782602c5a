"""neargrid_walk, from this launch's data, replayed on its inputs with the
reference's plain walk: the 32-byte rows (and with a stop set the known
byte) of the voxels its lanes touch, the 4-byte starts read and 5 bytes of
pos and done written a lane, and 15 f64 operations a lane-step (chip_smoke
``walk_cost``).  The rows are the wrapper's (N, 4) f64 tensor: the
gradient, then the int32 parent and flags in words 6 and 7."""
import torch

from reference import walk

WRAPPER = "pybader_tpu_torch.ops.neargrid:neargrid_walk_cuda"
KERNELS = ("walk_kernel",)


def cost(rows, starts, shape, max_steps, known=None):
    words = rows.view(torch.int32)
    st = {}
    walk(rows[:, :3], words[:, 6].long(), words[:, 7], starts, tuple(shape),
         max_steps, None if known is None else known.reshape(-1) == 2,
         stats=st)
    per_row = 32 + (0 if known is None else 1)
    return {"bytes": st["rows_touched"] * per_row + 9 * starts.numel(),
            "f64_ops": 15 * st["lane_steps"]}
