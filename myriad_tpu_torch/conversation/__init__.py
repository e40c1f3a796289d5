"""Chat over the port's Myriad (counterpart of ``myriad_tpu/conversation``)."""

from myriad_tpu_torch.conversation.conversation import CONV_VISION, Chat, Conversation

__all__ = ["Conversation", "Chat", "CONV_VISION"]
