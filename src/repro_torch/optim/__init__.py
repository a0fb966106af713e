from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, adamw_update_
from repro_torch.optim.compress import compress_int8, decompress_int8
