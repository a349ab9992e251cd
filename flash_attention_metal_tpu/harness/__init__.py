"""Kernel checks and serving/training measurement harnesses."""

from .verify import CHECKS, FULL, SMALL, RungResult, run_kernel_checks

__all__ = ["CHECKS", "FULL", "SMALL", "RungResult", "run_kernel_checks"]
