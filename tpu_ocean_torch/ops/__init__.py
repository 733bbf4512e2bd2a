"""Kernel-backed operators."""
