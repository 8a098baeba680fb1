"""Cross-silo message types (a copy of
``fedml_tpu/cross_silo/message_define.py``: the same numbers and keys, so
port and JAX parties share a session)."""


class MyMessage:
    # server -> client
    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
    MSG_TYPE_S2C_FINISH = 7
    # client -> server
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 3
    MSG_TYPE_C2S_CLIENT_STATUS = 5
    # payload keys
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_CLIENT_STATUS = "client_status"
    MSG_ARG_KEY_ROUND_IDX = "round_idx"
    MSG_ARG_KEY_CLIENT_METRICS = "client_metrics"
    # wire-efficient updates (utils/compression.py): a compressed delta
    # blob replaces MODEL_PARAMS in whichever direction is compressed;
    # WIRE_DTYPE tags a dense payload whose leaves cross at reduced
    # precision (bf16 bit views)
    MSG_ARG_KEY_MODEL_UPDATE = "model_update"
    MSG_ARG_KEY_WIRE_DTYPE = "wire_dtype"
    # adaptive wire pipeline (core/wire): the sync carries the round's
    # keep-ratio when the stats-driven schedule is on, so client uplinks
    # and the server decoder agree per round; absent otherwise (the
    # default wire stays byte-identical)
    MSG_ARG_KEY_CC_RATIO = "cc_ratio"
    # statuses
    MSG_CLIENT_STATUS_ONLINE = "ONLINE"
    MSG_CLIENT_STATUS_IDLE = "IDLE"
