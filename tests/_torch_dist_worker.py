"""Worker of tests/test_torch_dist_checkpoint.py's two-process step — NOT
collected by pytest.

Each of two processes joins one gloo process group through
flatquant_torch.parallel.distributed.init_distributed (the FLATQUANT_*
variables, as tests/_dist_worker.py joins JAX's processes), builds a
{dp 2} mesh over them, and runs ONE calibration step of tiny-llama's
layer 0 (the fp teacher given, the calib student, normalised MSE,
backward, AdamW) on its half of the batch: the gradient sum over dp
crosses the process boundary. Both write their part of {"fq": the new
state (replicated), "x": their rows of the batch} with save_sharded for
the parent to restore in one process.

    python tests/_torch_dist_worker.py INPUT_DIR
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from flatquant_torch.parallel.distributed import init_distributed  # noqa

rank = init_distributed(device="cpu")
torch.set_num_threads(1)

from flatquant_torch.calib import trainer as tt  # noqa: E402
from flatquant_torch.models.llama import (  # noqa: E402
    causal_mask,
    llama_layer,
    rope_tables,
)
from flatquant_torch.parallel.mesh import make_mesh  # noqa: E402
from flatquant_torch.utils.dist_checkpoint import save_sharded  # noqa: E402

out_dir = sys.argv[1]
inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
cfg, fq_cfg = inp["cfg"], inp["fq_cfg"]
mesh = make_mesh({"dp": 2}, device="cpu")
dp = mesh.axis("dp")
assert dp.size == 2 and dp.index == rank, (dp, rank)
x = inp["x"][dp.block(inp["x"].shape[0])]
teacher = inp["teacher"][dp.block(inp["teacher"].shape[0])]
S = x.shape[1]
cos, sin = rope_tables(cfg, torch.arange(S))
mask = causal_mask(S, "cpu")
state = tt._master(inp["fq"])
opt = tt.make_optimizer(fq_cfg, state, tt.build_labels(state), 1)
mse = tt.calib_step(
    opt, lambda f, lp, xx: llama_layer(cfg, fq_cfg, "calib", lp, f, xx, cos,
                                       sin, mask),
    state, inp["lp"], x, teacher, dp)
save_sharded(os.path.join(out_dir, "fq_step"), {"fq": state, "x": x},
             mesh=mesh, specs={"fq": None, "x": ("dp", 0)})
print(f"WORKER_OK {rank} mse={mse:.8f}", flush=True)
