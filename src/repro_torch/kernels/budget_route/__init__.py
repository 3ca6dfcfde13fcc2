from repro_torch.kernels.budget_route.ops import budget_route
from repro_torch.kernels.budget_route.ref import budget_route_ref
