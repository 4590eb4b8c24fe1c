from repro_torch.data.prism import PrismSource, snr_db  # noqa: F401
