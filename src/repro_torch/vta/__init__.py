from repro_torch.vta.isa import VTAConfig, DEFAULT_VTA
