"""Hub facade: ``s3prl_tpu_torch.hub.load("hubert_large_ll60k", ...)``
(port of s3prl_tpu/hub.py)."""

from .upstream.registry import load, options  # noqa: F401
