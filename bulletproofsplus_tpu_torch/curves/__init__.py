"""Point arithmetic of both families (edwards25519, secp256k1) and the point
kernels K2–K5."""
from .instances import CURVE_NAMES, curve_ops

__all__ = ["CURVE_NAMES", "curve_ops"]
