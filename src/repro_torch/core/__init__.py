"""The paper's contribution: ring index + Glushkov bit-parallel RPQs."""
from .delta import DeltaOverlay
from .engines import PlanCache, Query, eval_many, make_engine
from .glushkov import Glushkov
from .regex import parse, reverse, nullable
from .ring import LabeledGraph, Ring
from .rpq import QueryStats, RingRPQ
from .wavelet import BitVector, WaveletTree
