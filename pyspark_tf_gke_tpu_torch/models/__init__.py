"""The port's models. :func:`build_model` is the factory keyed by the
CLI's ``--model`` (counterpart of ``pyspark_tf_gke_tpu/models/
__init__.py::build_model``) for the names whose models the port has;
each model module is imported when its name is asked for."""


def build_model(name: str, **kw):
    """``mlp`` (``num_classes``, ``input_dim``), ``cnn`` (``num_outputs``,
    ``flat``, ``dtype``, ``image_size``), ``resnet50`` (``num_classes``,
    ``dtype``: None is f32, as in the JAX factory), ``bert``
    (``config``), ``causal_lm`` (``config``); other keywords go to the
    constructor (``device``, ``seed``, ``param_dtype``, ...)."""
    name = name.lower()
    if name == "mlp":
        from pyspark_tf_gke_tpu_torch.models.mlp import MLPClassifier

        return MLPClassifier(num_classes=kw.pop("num_classes", 10), **kw)
    if name == "cnn":
        from pyspark_tf_gke_tpu_torch.models.cnn import CNNRegressor

        return CNNRegressor(**kw)
    if name == "resnet50":
        from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50

        return ResNet50(num_classes=kw.pop("num_classes", 1000),
                        dtype=kw.pop("dtype", None), **kw)
    if name == "bert":
        from pyspark_tf_gke_tpu_torch.models.bert import (BertConfig,
                                                          BertForPretraining)

        return BertForPretraining(kw.pop("config", None) or BertConfig(), **kw)
    if name == "causal_lm":
        from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                               CausalLMConfig)

        return CausalLM(kw.pop("config", None) or CausalLMConfig(), **kw)
    raise ValueError(f"Unknown model {name!r}")
