from qbn_tpu_torch.serving.export import (LoadedPredictor, Predictor,
                                          export_predictor, load_predictor,
                                          make_predictor)

__all__ = ["LoadedPredictor", "Predictor", "export_predictor",
           "load_predictor", "make_predictor"]
