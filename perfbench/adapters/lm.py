"""A decoder LM of the program's zoo under the program: the registry's
algorithm with the per-client protocol, as ``launch/train.py`` builds it
(``lm_loss`` of the arch, minibatches of each client's token pool)."""
from __future__ import annotations

from functools import partial

SIZES = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
         "vocab_size", "rope_theta", "tie_embeddings")


def model_config(cfg):
    """The program's ModelConfig at the sizes and dtypes the file states;
    refuses an arch whose layers are not the file's."""
    from repro_torch.configs import get_config
    pc = get_config(cfg["arch"]).replace(
        **{k: cfg[k] for k in SIZES}, dtype=cfg["compute_dtype"],
        param_dtype=cfg["param_dtype"])
    plain = (pc.nonparametric_ln and not pc.prefix and pc.moe is None
             and pc.mamba is None and not pc.encdec and not pc.frontend
             and all(sp.kind == "attn" and sp.attn == "full"
                     and sp.mlp == "dense" and sp.use_rope
                     for sp in pc.schedule)
             and not (pc.qk_norm or pc.logit_softcap or pc.attn_softcap))
    if not plain:
        raise ValueError(f"{cfg['arch']}: not the dense decoder that "
                         f"configs/{cfg['name']}.json states")
    return pc


def build(cfg, traffic, leaves, device, fed):
    from repro_torch.data.synthetic import token_batch
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.models.model import abstract_lm, lm_loss
    pc = model_config(cfg)
    template = abstract_lm(pc)[0]
    got = [(k, tuple(template[k].shape)) for k in sorted(template)]
    want = [(name, tuple(shape)) for name, shape, _ in leaves]
    if got != want:
        raise ValueError(f"the program's leaves {got} are not the "
                         f"reference's {want}")
    return make_algorithm(traffic["algorithm"], fed,
                          loss_fn=partial(lm_loss, pc), template=template,
                          batch_fn=token_batch, batch_size=traffic["batch"],
                          device=device)
