"""The paper's baseline intermediate filters (host numpy): 5C+CH and RA."""
from .fivec_ch import FiveCCH, build_5cch, fivecch_verdict_pair  # noqa: F401
from .ra import RAStore, build_ra, ra_verdict_pair  # noqa: F401
