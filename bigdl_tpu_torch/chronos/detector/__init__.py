from bigdl_tpu_torch.chronos.detector.anomaly import (
    AEDetector, DBScanDetector, ThresholdDetector)

__all__ = ["ThresholdDetector", "AEDetector", "DBScanDetector"]
