"""Parameter attributes. Counterpart of ``ParamAttr`` in
``paddle_tpu/nn/initializer/__init__.py`` (the initializers themselves
are a later slice).

``ParamAttr`` carries ``name``, ``learning_rate``, ``regularizer``,
``trainable`` and ``need_clip`` (a parameter's name is its module path,
so ``name`` stays on the ``ParamAttr``); the layers that take
``weight_attr=`` / ``bias_attr=`` (``Linear``, ``Embedding``,
``LayerNorm``) put the others on the ``nn.Parameter`` they make, where the
optimizer and the clips read them:

- ``optimize_attr = {'learning_rate': ...}``: the parameter's learning
  rate is the optimizer's times this;
- ``regularizer``: replaces the optimizer's ``weight_decay`` for it;
- ``need_clip``: False exempts its gradient from the clip;
- ``requires_grad = trainable``.

``bias_attr=False`` means no bias, as in the reference. Note that
``copy.deepcopy`` of a ``Parameter`` copies its data and not these
attributes (torch's ``Parameter.__deepcopy__``): ``copy_param_attrs``
carries them from one module to a copy of it.
"""
__all__ = ['ParamAttr', 'apply_param_attr', 'copy_param_attrs']

_ATTRS = ('optimize_attr', 'regularizer', 'need_clip')


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        if initializer is not None:
            raise NotImplementedError(
                "ParamAttr: initializer= is not ported yet (initializers "
                "are a later slice); the layers draw their reference "
                "distributions from their generator")
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        """``None`` -> a default ``ParamAttr``, a ``str`` -> one with that
        name, a bool -> a default one (True) or False (no parameter)."""
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        raise TypeError(f"Invalid param attr: {arg!r}")

    def __repr__(self):
        return (f"ParamAttr(name={self.name!r}, learning_rate="
                f"{self.learning_rate}, regularizer={self.regularizer!r}, "
                f"trainable={self.trainable}, need_clip={self.need_clip})")


def apply_param_attr(param, attr):
    """Put ``attr``'s settings on ``param`` (an ``nn.Parameter``) ->
    ``param``."""
    attr = ParamAttr._to_attr(attr)
    param.optimize_attr = {'learning_rate': float(attr.learning_rate)}
    param.regularizer = attr.regularizer
    param.need_clip = bool(attr.need_clip)
    param.requires_grad_(bool(attr.trainable))
    return param


def copy_param_attrs(src, dst):
    """Carry the ``ParamAttr`` settings of ``src``'s parameters onto the
    same-named parameters of ``dst`` (a copy of ``src``)."""
    own = dict(dst.named_parameters())
    for name, p in src.named_parameters():
        q = own.get(name)
        if q is None:
            continue
        for a in _ATTRS:
            if hasattr(p, a):
                setattr(q, a, getattr(p, a))
        q.requires_grad_(p.requires_grad)
    return dst
