"""Multi-client round engine over the step-program IR
(`repro_torch.engine.program`)."""
from repro_torch.engine.engine import RoundEngine  # noqa: F401
from repro_torch.engine.fleet import (FleetMeshMixin,  # noqa: F401
                                      FleetRoundEngine, FleetSpec)
from repro_torch.engine.program import (Aggregate, ClientBwd,  # noqa: F401
                                        ClientFwd, ExecContext, RecvGrad,
                                        SendCut, ServerFwdBwd, Step,
                                        StepProgram, WeightHandoff,
                                        copy_tree, stack_batches,
                                        stack_state, stack_trees, tree_at,
                                        tree_index, tree_mean0, tree_update,
                                        unstack_state, unstack_tree)
from repro_torch.engine.topology import (Topology,  # noqa: F401
                                         extended_vanilla, lower,
                                         lower_baseline, multihop,
                                         multitask, u_shaped, vanilla,
                                         vertical)
