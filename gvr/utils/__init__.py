from gvr.utils.image import psnr, mse

__all__ = ["psnr", "mse"]
