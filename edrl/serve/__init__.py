from edrl.serve.predictor import Predictor

__all__ = ["Predictor"]
