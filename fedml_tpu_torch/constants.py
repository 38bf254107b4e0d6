"""Framework-wide names (port subset of ``fedml_tpu/constants.py``).

The partition methods, simulation backends, federated optimizer names
and the defense and attack vocabularies the ported slices read. The
values are the JAX package's, so one YAML drives either package.
"""

# the MNIST LEAF archive (reference constants.py:18)
FEDML_DATA_MNIST_URL = "https://fedcv.s3.us-west-1.amazonaws.com/MNIST.zip"

# simulation sub-backends
FEDML_SIMULATION_TYPE_SP = "single_process"
FEDML_SIMULATION_TYPE_MESH = "MESH"
FEDML_SIMULATION_TYPE_NCCL = "NCCL"  # accepted as an alias of MESH

# data partition methods
PARTITION_HOMO = "homo"
PARTITION_HETERO = "hetero"

# federated optimizers
FED_OPTIMIZER_FEDAVG = "FedAvg"

# training platforms
FEDML_TRAINING_PLATFORM_SIMULATION = "simulation"
FEDML_TRAINING_PLATFORM_DISTRIBUTED = "distributed"

# Robust-aggregation defenses and the poisoning attacks they defend
# against: ONE vocabulary, which the knob validation (arguments.py),
# RobustAggregator, needs_full_cohort and the poisoned-world loader all
# check against, so an unknown string fails loudly everywhere instead of
# aggregating undefended
DEFENSE_NORM_DIFF_CLIPPING = "norm_diff_clipping"
DEFENSE_WEAK_DP = "weak_dp"
DEFENSE_MEDIAN = "median"
DEFENSE_TYPES = (DEFENSE_NORM_DIFF_CLIPPING, DEFENSE_WEAK_DP, DEFENSE_MEDIAN)
POISON_TYPES = ("label_flip", "targeted_flip", "backdoor_pattern", "edge_case")
