"""Classification heads (`MViT/slowfast/models/head_helper.py`)."""

from torch import nn

from pmv_tpu_torch.models.common import Linear


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
    (`head_helper.py:502-577`, without the contrastive projection MLP)."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0,
                 act_func="softmax", detach_final_fc=False):
        super().__init__()
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else nn.Identity()
        self.projection = Linear(dim_in, num_classes)
        self.act_func = act_func
        self.detach_final_fc = detach_final_fc

    def forward(self, x):
        x = self.dropout(x)
        if self.detach_final_fc:
            x = x.detach()
        x = self.projection(x)
        if not self.training:
            x = head_act(x, self.act_func)
        return x
