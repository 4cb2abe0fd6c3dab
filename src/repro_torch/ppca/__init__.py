"""Paper's application: (distributed) probabilistic PCA for SfM."""
from repro_torch.ppca.dppca import DPPCA, DPPCAState, max_subspace_angle
from repro_torch.ppca.ppca import (EStats, PPCAParams, e_step, fit_em,
                                   fit_svd, init_params, m_step, nll,
                                   subspace_angle)
from repro_torch.ppca.synth import (SfMData, SubspaceData, subspace_data,
                                    turntable_sfm)

__all__ = [
    "DPPCA", "DPPCAState", "max_subspace_angle",
    "EStats", "PPCAParams", "e_step", "fit_em", "fit_svd", "init_params",
    "m_step", "nll", "subspace_angle",
    "SfMData", "SubspaceData", "subspace_data", "turntable_sfm",
]
