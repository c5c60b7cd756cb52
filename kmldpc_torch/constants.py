"""Numerical constants shared across the framework.

Mirrors the constants of the reference simulator
(the reference's ``kmldpc/lib/lab/include/utility.h:10-20``) so that the
TPU-native pipeline clips probabilities / LLRs at the same points and the
resulting BER/FER statistics are comparable.  Copy of
``kmldpc_tpu/constants.py``: the port imports nothing of the JAX package.
"""

import math

PI = math.pi

# Smallest probability any message is allowed to take.  The reference clips
# every probability-domain message into [SMALLEST_PROB, 1 - SMALLEST_PROB]
# (utility.cc:19-27, binaryldpccodec.cc:262-266).
SMALLEST_PROB = 1.0e-12

# The LLR value equivalent to the probability clip above:
#   log((1 - 1e-12) / 1e-12) = 27.6310211159...
# Our belief-propagation decoder works in the LLR domain (the tanh rule is
# mathematically identical to the reference's normalized probability-domain
# trellis sweeps), so the probability clip becomes a symmetric LLR clip.
LLR_CLIP = math.log((1.0 - SMALLEST_PROB) / SMALLEST_PROB)

# The reference also defines +-28 as hard LLR bounds (utility.h:18-20).
SMALLEST_LLR = -28.0
LARGEST_LLR = 28.0

SQRT2 = math.sqrt(2.0)

# Guard used when dividing by tanh-products inside the check-node update; has
# no reference analogue (the reference's trellis sweep never divides) but any
# value far below SMALLEST_PROB leaves the statistics untouched.
TINY = 1.0e-30
