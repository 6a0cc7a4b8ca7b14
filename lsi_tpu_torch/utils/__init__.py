"""Numeric helpers of the render stack."""
