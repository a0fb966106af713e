from repro_torch.data.synthetic import (audio_stub_batch, digits_batch, lm_batch,
                                        vlm_stub_batch, vlm_stub_extras)
