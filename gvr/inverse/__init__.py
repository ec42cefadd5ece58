from gvr.inverse.fit import fit_gaussians, fit_loss, FitState
from gvr.inverse.sfd import sfd_gradient

__all__ = ["fit_gaussians", "fit_loss", "FitState", "sfd_gradient"]
