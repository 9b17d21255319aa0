from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM  # noqa: F401
