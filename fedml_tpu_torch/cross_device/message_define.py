"""Cross-device protocol message vocabulary.

Parity target: reference ``cross_device/server_mnn/message_define.py`` (the
MNN server speaks start-train JSON + model-file messages to phones). Keys
are file-payload centric: model parameters travel as *artifact files* on a
shared medium (the cross-device analogue of the reference's S3+MNN file
exchange), messages carry paths + metadata."""


class DeviceMessage:
    # device -> server
    MSG_TYPE_D2S_REGISTER = "d2s_register"
    MSG_TYPE_D2S_MODEL = "d2s_model"
    # server -> device
    MSG_TYPE_S2D_INIT = "s2d_init"
    MSG_TYPE_S2D_SYNC = "s2d_sync"
    MSG_TYPE_S2D_FINISH = "s2d_finish"

    ARG_DEVICE_ID = "device_id"
    ARG_DEVICE_OS = "device_os"
    ARG_DEVICE_ENGINE = "device_engine"
    # eligibility analogues on the registration handshake (Bonawitz
    # MLSys'19 §2: phones check in when charging + idle + on an unmetered
    # network; the server's cohort assembly filters on them). Absent
    # fields read as True — a device that predates the fields stays
    # schedulable.
    ARG_DEVICE_CHARGING = "device_charging"
    ARG_DEVICE_IDLE = "device_idle"
    ARG_DEVICE_UNMETERED = "device_unmetered"
    ARG_MODEL_FILE = "model_file"
    ARG_ROUND_IDX = "round_idx"
    ARG_DATA_SILO_IDX = "data_silo_idx"
    ARG_NUM_SAMPLES = "num_samples"
    ARG_TRAIN_LOSS = "train_loss"
    # on-device eval of the received GLOBAL model on the device's shard
    # (reference: MobileNN's on-device test path; reported natively)
    ARG_DEVICE_EVAL_ACC = "device_eval_acc"

    STATUS_ONLINE = "ONLINE"
    STATUS_FINISHED = "FINISHED"
