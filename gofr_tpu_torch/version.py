"""Framework version (reference: pkg/gofr/version/version.go:3); the port's
copy of ``gofr_tpu/version.py``."""

FRAMEWORK = "dev"
