"""Model registry (port of reslic_tcm_tpu/models/__init__.py).

``get_model(args)`` builds the codec named by ``args.model`` with the JAX
registry's constructor arguments and returns the same five-tuple
(codec, gaussian_configuration, annealing_strategy_gaussian,
factorized_configuration, annealing_strategy_factorized). The port builds
TCM, WACNN, the Balle-2018 family (factorized, scale_hyperprior,
mean_scale_hyperprior), the STanH codecs (stanh, wacnn_stanh,
scale_stanh) and the gain codecs (scale_gain, wacnn_gain, scale_gain_sc):
every name of the JAX registry.
"""

from __future__ import annotations

# registry names the port does not build yet -> the ROADMAP item that brings each
NOT_PORTED: dict[str, str] = {}
# the Balle-2018 registry names -> make_balle's kind
BALLE_KINDS = {"factorized": "factorized", "scale_hyperprior": "scale",
               "mean_scale_hyperprior": "mean-scale"}


def get_model(args, device="cuda"):
    """Build the codec ``args.model`` (with ``args.N``, ``args.M`` and, for
    the STanH names, the train parser's ``--gauss_*``, ``--symmetry``,
    ``--removing_mean``, ``--refinement`` and ``--lambda_list``; for the
    gain names one level per lambda and ``--gain_init_spread``) on
    ``device`` with seeded random weights."""
    name = args.model
    if name in NOT_PORTED:
        raise NotImplementedError(f"--model {name} is not ported yet: {NOT_PORTED[name]}")
    if name in ("wacnn_stanh", "stanh", "scale_stanh"):
        from ..utils.helper import configure_annealings, configure_latent_space_policy
        from .stanh import variants

        if name == "scale_stanh":  # one rate level, as the JAX registry builds it
            gcfg = configure_latent_space_policy(args)
            codec = variants.make_scale_stanh(gcfg, N=args.N, M=args.M, fact_stanh=True,
                                              device=device)
            return (codec, gcfg, configure_annealings(gcfg[0]), gcfg,
                    configure_annealings(gcfg[0]))
        gcfg = configure_latent_space_policy(args, multi=len(args.lambda_list) > 1)
        if len(gcfg) < len(args.lambda_list):
            gcfg = gcfg * len(args.lambda_list)
        if name == "wacnn_stanh":
            codec = variants.make_wacnn_stanh(gcfg, N=args.N, M=args.M,
                                              refinement=args.refinement, device=device)
            return codec, gcfg, configure_annealings(gcfg[0]), None, None
        # TCM-STanH: M fixed at 320, the TCM module's defaults
        codec = variants.make_tcm_stanh(gcfg, N=args.N, M=320, device=device)
        return codec, gcfg, configure_annealings(gcfg[0]), gcfg, configure_annealings(gcfg[0])
    if name in ("scale_gain", "wacnn_gain", "scale_gain_sc"):
        from .gain import gained, sc

        spread = getattr(args, "gain_init_spread", 0.0)
        if name == "scale_gain_sc":  # as in the JAX registry, no ladder here
            codec = sc.make_sc_gained(N=args.N, M=args.M, lmbda_list=args.lambda_list,
                                      device=device)
        elif name == "scale_gain":
            codec = gained.make_gained_hyperprior("scale", N=args.N, M=args.M,
                                                  lmbda_list=args.lambda_list, device=device,
                                                  gain_init_spread=spread)
        else:
            codec = gained.make_gained_wacnn(N=args.N, M=args.M, lmbda_list=args.lambda_list,
                                             device=device, gain_init_spread=spread)
        return codec, None, None, None, None
    if name == "wacnn":
        from .wacnn import make_wacnn

        return make_wacnn(N=args.N, M=args.M, device=device), None, None, None, None
    if name in BALLE_KINDS:
        from .balle2018 import make_balle

        codec = make_balle(BALLE_KINDS[name], N=args.N, M=args.M, device=device)
        return codec, None, None, None, None
    if name == "tcm":
        from .tcm import make_tcm

        # the JAX registry's TCM: M fixed at 320, the reference's depths, no
        # drop-path, remat unless --no-remat
        return (make_tcm(N=args.N, M=320, device=device, drop_path_rate=0.0,
                         remat=bool(getattr(args, "remat", True))), None, None, None, None)
    raise ValueError(f"unknown model {name!r}")
