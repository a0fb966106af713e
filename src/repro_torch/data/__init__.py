from repro_torch.data.synthetic import digits_batch, vlm_stub_extras
