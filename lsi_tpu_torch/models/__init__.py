"""The LDI predictor network and its weight converter."""
