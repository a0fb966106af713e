from repro_torch.kernels.act_pool.act_pool import act_pool_cuda, kernel_plan, launch_plan
from repro_torch.kernels.act_pool.ops import act_pool
from repro_torch.kernels.act_pool.ref import act_pool_kernel_ref, act_pool_ref, tanh_table
