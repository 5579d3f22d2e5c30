"""Multi-rank sharding of the port on ``torch.distributed``: the (channel,
block) mesh (:mod:`.mesh`), the halo shifts (:mod:`.halo`), the sharded
scheme convolution and streaming (:mod:`.sharded`), the distributed
four-step FFT (:mod:`.fft_sharded`) and a launcher of CPU ranks over gloo
with the multi-rank dry run (:mod:`.launch`). The exports are those of the
JAX package's ``parallel``."""

from .mesh import (  # noqa: F401
    BLOCK_AXIS,
    CHANNEL_AXIS,
    channel_sharding,
    channel_time_sharding,
    make_mesh,
    replicated,
)
from .halo import left_halo, shift_from_left  # noqa: F401
from .fft_sharded import (  # noqa: F401
    convolve_sharded,
    fft_sharded,
    real_sharded_eligible,
    rfft_sharded,
    rifft_sharded,
    sharded_eligible,
)
from .sharded import (  # noqa: F401
    n_to_one_offline,
    scheme_offline_sharded,
    scheme_stream_any_sharded,
    scheme_stream_sharded,
)
