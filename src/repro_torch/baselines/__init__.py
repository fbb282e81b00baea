from repro_torch.baselines.binary_join import binary_join_agg
from repro_torch.baselines.preagg import preagg_join_agg

__all__ = ["binary_join_agg", "preagg_join_agg"]
