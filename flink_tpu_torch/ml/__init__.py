"""ML pipelines — the FlinkML analog (ref flink-ml, SURVEY §2.7): the port
of flink_tpu/ml/, with the reference's exports."""

from flink_tpu_torch.ml.pipeline import (
    ALS,
    KNN,
    SVM,
    KMeans,
    MinMaxScaler,
    MultipleLinearRegression,
    Pipeline,
    PolynomialFeatures,
    Predictor,
    StandardScaler,
    Transformer,
)

__all__ = [
    "ALS", "Pipeline", "Transformer", "Predictor", "StandardScaler",
    "MinMaxScaler", "PolynomialFeatures", "MultipleLinearRegression",
    "SVM", "KMeans", "KNN",
]
