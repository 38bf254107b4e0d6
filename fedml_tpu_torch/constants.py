"""Framework-wide names (port subset of ``fedml_tpu/constants.py``).

The partition methods, simulation backends, federated optimizer names,
the defense and attack vocabularies, and the comm backends, message
types and message keys of the comm layer, serving, the cross-silo
managers (the silo control plane and the edge tier's) and the
cross-device planes (the legacy model-file server's status and finish
messages above, the Beehive check-in protocol below). The values are
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
FEDML_TRAINING_PLATFORM_CROSS_DEVICE = "cross_device"

# cross-silo scenarios
FEDML_CROSS_SILO_SCENARIO_HORIZONTAL = "horizontal"
FEDML_CROSS_SILO_SCENARIO_HIERARCHICAL = "hierarchical"

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

# the cross-device Beehive check-in protocol (cross_device/gateway.py and
# device.py): a device CHECKs IN with its round-scoped mask public key,
# pulls the ROUND_OFFER (int8 params, the participants' keys), pushes
# ONE masked quantized delta and disappears. WINDOW_TICKs stand in for
# the windows' wall-clock expiry; SHARE_REQUEST/REVEAL recovers the
# masks of devices that vanished; ROUND_RESULT announces a close
MSG_TYPE_D2S_DEVICE_CHECKIN = 70
MSG_TYPE_S2D_ROUND_OFFER = 71
MSG_TYPE_D2S_MASKED_UPLOAD = 72
MSG_TYPE_D2S_WINDOW_TICK = 73
MSG_TYPE_S2D_SHARE_REQUEST = 74
MSG_TYPE_D2S_SHARE_REVEAL = 75
MSG_TYPE_S2D_ROUND_RESULT = 76
MSG_ARG_KEY_DEVICE_ID = "device_id"
MSG_ARG_KEY_DEVICE_PUBKEY = "device_pubkey"
MSG_ARG_KEY_MASKED_DELTA = "masked_delta"
MSG_ARG_KEY_MASK_CHECKSUM = "mask_checksum"
MSG_ARG_KEY_PARTICIPANTS = "participants"
MSG_ARG_KEY_QUANT_SCALE = "quant_scale"
MSG_ARG_KEY_SHARE_REVEALS = "share_reveals"
MSG_ARG_KEY_WINDOW_PHASE = "window_phase"
MSG_ARG_KEY_CLOSE_INFO = "close_info"

# the window a WINDOW_TICK closes (check-in gathers the participants,
# the report window bounds the uploads)
DEVICE_WINDOW_CHECKIN = "checkin"
DEVICE_WINDOW_REPORT = "report"
# why the gateway closed a round: its fold target, or the window's end
# (never cohort completeness)
DEVICE_CLOSE_TARGET = "target"
DEVICE_CLOSE_WINDOW = "window"

# -- the performance-attribution plane (analysis/perf.py, chip_smoke.py) --
# bf16 dense peak TFLOP/s per device by device kind: the one table every
# MFU and roofline denominator comes from. The TPU rows are the JAX
# package's, verbatim (its own spec-sheet numbers, kept so that `cli
# perf --ratchet` groups the repo's BENCH_*.json records as it does);
# they describe TPUs, not the port. The card's row is keyed by
# torch.cuda.get_device_name(0): the H100 SXM data sheet's dense bf16
# peak. Unknown kinds report achieved FLOP/s without an MFU.
PEAK_BF16_TFLOPS = {
    "TPU v4": 275.0,
    "TPU v5 lite": 197.0,
    "TPU v5e": 197.0,
    "TPU v5p": 459.0,
    "TPU v6 lite": 918.0,
    "TPU v6e": 918.0,
    "NVIDIA H100 80GB HBM3": 989.0,
}

# HBM bandwidth per device (TB/s, the same sheets): the roofline ridge
# point peak_flops / bandwidth decides a compute- or memory-bound verdict
HBM_BANDWIDTH_TBPS = {
    "TPU v4": 1.2,
    "TPU v5 lite": 0.82,
    "TPU v5e": 0.82,
    "TPU v5p": 2.77,
    "TPU v6 lite": 1.64,
    "TPU v6e": 1.64,
    "NVIDIA H100 80GB HBM3": 3.35,
}


def normalize_device_kind(kind: str) -> str:
    """Canonical device-kind label for bench meta and ratchet grouping:
    strips per-device ordinals (``"TPU v5 lite0"`` -> ``"TPU v5 lite"``)
    and folds every CPU spelling (``TFRT_CPU_0``, ``cpu``, ``Cpu0``) to
    ``"cpu"``, as the JAX package's function does."""
    k = str(kind or "").strip()
    if "cpu" in k.lower():
        return "cpu"
    # longest match against the table, so "TPU v4i" never folds into
    # "TPU v4"; an ordinal suffix (digits) is tolerated
    best = ""
    low = k.lower()
    for name in PEAK_BF16_TFLOPS:
        nl = name.lower()
        if (low == nl or low.startswith(nl)) and len(name) > len(best):
            rest = low[len(nl):]
            if rest == "" or rest.isdigit():
                best = name
    return best or k


def peak_bf16_flops(kind: str) -> float:
    """bf16 peak in FLOP/s for ``kind`` (ordinal suffix OK), or 0.0 when
    unknown: callers treat 0 as "report achieved FLOP/s without an MFU"."""
    return PEAK_BF16_TFLOPS.get(normalize_device_kind(kind), 0.0) * 1e12


def hbm_bandwidth_bytes(kind: str) -> float:
    """HBM bandwidth in bytes/s, or 0.0 when unknown."""
    return HBM_BANDWIDTH_TBPS.get(normalize_device_kind(kind), 0.0) * 1e12
