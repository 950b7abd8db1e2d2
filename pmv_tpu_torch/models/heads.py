"""Classification heads (`MViT/slowfast/models/head_helper.py`)."""

from torch import nn

from pmv_tpu_torch.models.common import Dropout, Linear


def head_act(x, act_func):
    """The eval-time head activation, computed in float32."""
    if act_func == "softmax":
        return x.float().softmax(dim=-1)
    if act_func == "sigmoid":
        return x.float().sigmoid()
    if act_func == "none" or act_func is None:
        return x
    raise NotImplementedError(f"{act_func} head activation unsupported")


class TransformerBasicHead(nn.Module):
    """Dropout + linear, then the activation at eval only
    (`head_helper.py:502-577`, without the contrastive projection MLP).
    In training the dropout applies ``dropout_mask`` [B, dim_in], drawn
    with ``self.dropout.sample``."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0,
                 act_func="softmax", detach_final_fc=False):
        super().__init__()
        self.dim_in = dim_in
        self.dropout = Dropout(dropout_rate)
        self.projection = Linear(dim_in, num_classes)
        self.act_func = act_func
        self.detach_final_fc = detach_final_fc

    def forward(self, x, dropout_mask=None):
        x = self.dropout(x, dropout_mask)
        if self.detach_final_fc:
            x = x.detach()
        x = self.projection(x)
        if not self.training:
            x = head_act(x, self.act_func)
        return x
