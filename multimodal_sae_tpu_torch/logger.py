"""The package logger (multimodal_sae_tpu/logger.py).

The JAX package's logger opens its file when it is imported.  Here importing
opens nothing: `logger` is the package's `logging` logger (every module's
`logging.getLogger(__name__)` is below it), at the level `MMSAE_LOG_LEVEL`
names, and the CLIs call `log_to_file()`, which adds the file handler
(`MMSAE_LOG_FILE`, default `multimodal_sae_tpu_torch.log`) once."""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("multimodal_sae_tpu_torch")
logger.setLevel(os.environ.get("MMSAE_LOG_LEVEL", "INFO").upper())


def log_to_file() -> logging.Logger:
    """Send the package's records to `MMSAE_LOG_FILE` as well (once)."""
    path = os.path.abspath(os.environ.get("MMSAE_LOG_FILE", "multimodal_sae_tpu_torch.log"))
    if not any(getattr(h, "baseFilename", None) == path for h in logger.handlers):
        handler = logging.FileHandler(path)
        handler.setLevel(logger.level)
        handler.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        logger.addHandler(handler)
    return logger
