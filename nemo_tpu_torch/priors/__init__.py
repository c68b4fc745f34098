"""Pose priors: GMoF, GMM, VPoser (port of nemo_tpu.priors)."""
