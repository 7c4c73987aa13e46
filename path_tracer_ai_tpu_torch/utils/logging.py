"""Stdlib logging helpers (counterpart of path_tracer_ai_tpu.utils.logging)."""

from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def render_banner(log: logging.Logger, settings) -> None:
    """Mirrors the render-settings banner (renderer.hpp:41-44)."""
    log.info("Starting render with settings:")
    log.info("Resolution: %dx%d", settings.width, settings.height)
    log.info("Samples per pixel: %d", settings.samples_per_pixel)
    log.info("Max bounces: %d", settings.max_bounces)
