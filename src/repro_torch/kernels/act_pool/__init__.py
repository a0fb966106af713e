from repro_torch.kernels.act_pool.act_pool import act_pool_cuda
from repro_torch.kernels.act_pool.ops import act_pool
from repro_torch.kernels.act_pool.ref import act_pool_ref
