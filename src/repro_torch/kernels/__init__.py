"""Kernel packages of the port, one per reference kernel package."""
