from .kernel import (PHASES, dadd_chain_cuda, online_replay_cuda,
                     path_rows, phase_ns, reset_path_rows, walk_chain_cuda)
from .ops import online_replay
from .ref import np_sum_order, online_replay_ref, online_replay_rows_ref
