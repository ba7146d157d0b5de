from .kernel import dadd_chain_cuda, online_replay_cuda
from .ops import online_replay
from .ref import online_replay_ref
