from repro_torch.data.pipeline import DataConfig, ZipfMarkov, calibration_batches

__all__ = ["DataConfig", "ZipfMarkov", "calibration_batches"]
