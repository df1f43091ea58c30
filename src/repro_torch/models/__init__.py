from repro_torch.models import registry  # noqa: F401
