"""The networks (the LDI predictor and the MPI baseline) and their weight
converter."""


def build_model(model_cfg):
    """Model-family dispatch, as ``lsi_tpu.train.trainer.build_model``: the
    LDI predictor (``family="ldi"``) or the layered-planes MPI baseline
    (``family="mpi"``). Parameters are allocated, not initialised."""
    if model_cfg.family == "mpi":
        from lsi_tpu_torch.models.mpi import MPIPredictor
        return MPIPredictor(model_cfg)
    if model_cfg.family != "ldi":
        raise ValueError(
            f"unknown model family {model_cfg.family!r}; use ldi|mpi")
    from lsi_tpu_torch.models.ldi_predictor import LDIPredictor
    return LDIPredictor(model_cfg)
