"""Rotations, cameras and host-side Procrustes (port of nemo_tpu.geometry)."""
