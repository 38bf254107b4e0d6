"""Framework-wide names (port subset of ``fedml_tpu/constants.py``).

The partition methods, simulation backends, federated optimizer names,
the defense and attack vocabularies, and the comm backends, message
types and message keys of the comm layer, serving and the cross-silo
managers (the silo control plane and the edge tier's). The values are
the JAX package's, so one YAML drives either package and the two
interoperate on the wire.
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
FEDML_TRAINING_PLATFORM_CROSS_SILO = "cross_silo"

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

# Communication backends (the reference's client_manager.py:27-94
# dispatch table)
COMM_BACKEND_LOCAL = "LOCAL"  # in-process queues (tests / single host)
COMM_BACKEND_GRPC = "GRPC"
COMM_BACKEND_TRPC = "TRPC"  # persistent-pipe raw-tensor RPC (TensorPipe analog)
COMM_BACKEND_MPI = "MPI"  # accepted; mapped onto the LOCAL transport
COMM_BACKEND_MQTT = "MQTT"
COMM_BACKEND_MQTT_S3 = "MQTT_S3"
COMM_BACKEND_SP = "sp"
COMM_BACKEND_MESH = "MESH"

# Message protocol shared by the managers (reference: simulation/
# mpi_p2p_mp/fedavg/message_define.py:1-31)
MSG_TYPE_S2C_INIT_CONFIG = 1
MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 3
MSG_TYPE_C2S_CLIENT_STATUS = 5
MSG_TYPE_S2C_FINISH = 7
MSG_TYPE_C2S_FINISH_ACK = 8
MSG_TYPE_CONNECTION_IS_READY = 0
# liveness beats and the reconnect downlink (core/comm/heartbeat.py)
MSG_TYPE_C2S_HEARTBEAT = 9
MSG_TYPE_S2C_RESYNC = 10
# server-internal loopbacks: the aggregation deadline fired, the failure
# detector declared a client dead
MSG_TYPE_S2S_AGG_DEADLINE = 30
MSG_TYPE_S2S_CLIENT_DEAD = 31
# the serving plane's request/response pair (serving/frontends.py)
MSG_TYPE_C2S_INFER_REQUEST = 40
MSG_TYPE_S2C_INFER_RESPONSE = 41
# the reliable channel's comm-layer ACK (core/comm/reliable.py): never
# reaches an application handler
MSG_TYPE_COMM_ACK = 50

MSG_ARG_KEY_TYPE = "msg_type"
MSG_ARG_KEY_SENDER = "sender"
MSG_ARG_KEY_RECEIVER = "receiver"
MSG_ARG_KEY_MODEL_PARAMS = "model_params"
MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
MSG_ARG_KEY_CLIENT_STATUS = "client_status"
MSG_ARG_KEY_ROUND_INDEX = "round_idx"
MSG_ARG_KEY_MODEL_FILE_URL = "model_file_url"
# compressed uplinks carry an encoded delta instead of model_params
MSG_ARG_KEY_MODEL_DELTA = "model_delta"
# reliable channel: (channel id, sequence) of a tracked message, echoed
# by its ACK
MSG_ARG_KEY_COMM_SEQ = "comm_seq"
MSG_ARG_KEY_COMM_CHAN = "comm_chan"
MSG_ARG_KEY_COMM_ACK_SEQ = "comm_ack_seq"
MSG_ARG_KEY_COMM_ACK_CHAN = "comm_ack_chan"
MSG_ARG_KEY_RANK = "rank"
# distributed-tracing context (core/tracing.py): the run-wide trace id,
# the sending span (the receiver's parent) and a per-send flow id
MSG_ARG_KEY_TRACE_ID = "trace_id"
MSG_ARG_KEY_TRACE_SPAN = "trace_span"
MSG_ARG_KEY_TRACE_FLOW = "trace_flow"
MSG_ARG_KEY_TRAIN_SECONDS = "train_seconds"
MSG_ARG_KEY_MODEL_VERSION = "model_version"

# presence states a client announces (OFFLINE: an elastic leave)
CLIENT_STATUS_ONLINE = "ONLINE"
CLIENT_STATUS_IDLE = "IDLE"
CLIENT_STATUS_OFFLINE = "OFFLINE"

# the hierarchical silo's control plane: the master ships [round_idx,
# params, client_index] to its slaves, then a finish
MSG_TYPE_SILO_SYNC_PROCESS_GROUP = 20
MSG_TYPE_SILO_FINISH = 21

# server-internal loopback: the quorum grace timer fired
MSG_TYPE_S2S_QUORUM_GRACE = 32

# the edge tier (cross_silo/hierarchical): an edge ships one merged
# limb-set a round (its folded and cohort ranks beside it) and forwards
# client death/leave/anomaly evidence; the root's round downlinks carry
# the edge's client -> silo assignment and the quarantine decision
MSG_TYPE_E2R_EDGE_REPORT = 60
MSG_TYPE_E2R_CLIENT_EVENT = 61
MSG_ARG_KEY_EDGE_STATE = "edge_state"
MSG_ARG_KEY_HIER_ASSIGNMENT = "hier_assignment"
MSG_ARG_KEY_QUARANTINED = "quarantined"
MSG_ARG_KEY_EVENT_KIND = "event_kind"
MSG_ARG_KEY_COHORT = "cohort"
MSG_ARG_KEY_FOLDED = "folded"
HIER_EVENT_DEAD = "dead"
HIER_EVENT_LEAVE = "leave"
HIER_EVENT_ONLINE = "online"
HIER_EVENT_QUARANTINE = "quarantine_evidence"
