"""The port's codec and selector suite.  Importing this package registers
every codec of the port (wire-stable ids, the reference's) and its
selectors.  Each codec encodes and decodes on the device its streams lie
on.

Codec ids (every one of the reference's):
   1 store   2 dup   3 delta   4 zigzag   5 transpose   6 bitpack   7 rle
   8 constant   9 tokenize   10 field_split   11 split_n   12 concat
  13 range_pack   14 huffman   15 fse   16 lz77   17 zlib_backend
  18 float_split   19 parse_numeric   20 csv_split   21 string_split   22 transpose_split   23 interpret_numeric
  24 lzma_backend   25 bz2_backend   26 fused_delta_bitpack   27 edge_list   28 adj_gap
  29 edge_list_bin

Selectors: entropy_auto, numeric_auto, bytes_auto, generic_auto, adjacency_auto.
"""
from . import coder_cache  # noqa: F401
from . import basic  # noqa: F401
from . import numeric  # noqa: F401
from . import entropy  # noqa: F401
from . import lz  # noqa: F401
from . import floats  # noqa: F401
from . import convert  # noqa: F401
from . import parse  # noqa: F401
from . import selectors  # noqa: F401
from . import graph  # noqa: F401
from . import profiles  # noqa: F401
from .coder_cache import (  # noqa: F401
    coder_cache_clear,
    coder_cache_disabled,
    coder_cache_info,
)
from .profiles import (  # noqa: F401
    SAO_FIELDS,
    SAO_HEADER_BYTES,
    csv_profile,
    graph_bin_profile,
    graph_profile,
    named_profiles,
    resolve_profile_spec,
    sao_profile,
    struct_profile,
)
