"""Framework-wide names (port subset of ``fedml_tpu/constants.py``).

The partition methods, simulation backends and federated optimizer
names the training slice reads. The values are the JAX package's, so
one YAML drives either package.
"""

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
