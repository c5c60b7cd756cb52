from .channel import fading_awgn_channel, partitioned_fading_awgn_channel  # noqa: F401
from .encode import encoder_table, make_encoder  # noqa: F401
from .modem import (  # noqa: F401
    ModemTables,
    make_mapper,
    make_partition_demapper,
    make_prior_demapper,
    make_soft_demapper,
)
from .source import chunk_seed, make_generator, random_bits, random_symbols  # noqa: F401
