from .types import Split, cmul, cmul_conj, packed_mul, packed_mul_conj  # noqa: F401
from .errors import ConvolveError, ConvolveException  # noqa: F401
