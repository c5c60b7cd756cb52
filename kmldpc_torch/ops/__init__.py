from .channel import fading_awgn_channel  # noqa: F401
from .encode import encoder_table, make_encoder  # noqa: F401
from .modem import ModemTables, make_mapper, make_soft_demapper  # noqa: F401
from .source import chunk_seed, make_generator, random_bits  # noqa: F401
