"""Stdlib logging helpers (counterpart of path_tracer_ai_tpu.utils.logging).

The reference prints scene stats, a settings banner and progress to stdout;
here they go through the logging module, and the CLI installs a plain
stdout handler to keep the reference's console output.
"""

from __future__ import annotations

import logging
import sys

ROOT_LOGGER = "path_tracer_ai_tpu_torch"


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def configure_cli_logging(level=logging.INFO) -> None:
    """Message-only stdout logging on the package's root logger, installed
    once per process."""
    root = logging.getLogger(ROOT_LOGGER)
    root.setLevel(level)
    if not any(getattr(h, "_pt_cli", False) for h in root.handlers):
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        handler._pt_cli = True
        root.addHandler(handler)


def render_banner(log: logging.Logger, settings) -> None:
    """Mirrors the render-settings banner (renderer.hpp:41-44)."""
    log.info("Starting render with settings:")
    log.info("Resolution: %dx%d", settings.width, settings.height)
    log.info("Samples per pixel: %d", settings.samples_per_pixel)
    log.info("Max bounces: %d", settings.max_bounces)
