# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: exhook.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x65xhook.proto\x12\x0e\x65mqx.exhook.v1\"\x0e\n\x0c\x45mptySuccess\"Q\n\nBrokerInfo\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x10\n\x08sysdescr\x18\x02 \x01(\t\x12\x0e\n\x06uptime\x18\x03 \x01(\x03\x12\x10\n\x08\x64\x61tetime\x18\x04 \x01(\t\"(\n\x08HookSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06topics\x18\x02 \x03(\t\"C\n\x15ProviderLoadedRequest\x12*\n\x06\x62roker\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.BrokerInfo\"9\n\x0eLoadedResponse\x12\'\n\x05hooks\x18\x01 \x03(\x0b\x32\x18.emqx.exhook.v1.HookSpec\"\x19\n\x17ProviderUnloadedRequest\"\xc3\x01\n\nClientInfo\x12\x0c\n\x04node\x18\x01 \x01(\t\x12\x10\n\x08\x63lientid\x18\x02 \x01(\t\x12\x10\n\x08username\x18\x03 \x01(\t\x12\x10\n\x08password\x18\x04 \x01(\t\x12\x10\n\x08peerhost\x18\x05 \x01(\t\x12\x10\n\x08sockport\x18\x06 \x01(\r\x12\x10\n\x08protocol\x18\x07 \x01(\t\x12\x12\n\nmountpoint\x18\x08 \x01(\t\x12\x14\n\x0cis_superuser\x18\t \x01(\x08\x12\x11\n\tanonymous\x18\n \x01(\x08\"q\n\x07Message\x12\x0c\n\x04node\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\x12\x0b\n\x03qos\x18\x03 \x01(\r\x12\x0c\n\x04\x66rom\x18\x04 \x01(\t\x12\r\n\x05topic\x18\x05 \x01(\t\x12\x0f\n\x07payload\x18\x06 \x01(\x0c\x12\x11\n\ttimestamp\x18\x07 \x01(\x04\"\'\n\x08Property\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"\x9a\x01\n\x08\x43onnInfo\x12\x0c\n\x04node\x18\x01 \x01(\t\x12\x10\n\x08\x63lientid\x18\x02 \x01(\t\x12\x10\n\x08username\x18\x03 \x01(\t\x12\x10\n\x08peerhost\x18\x04 \x01(\t\x12\x10\n\x08sockport\x18\x05 \x01(\r\x12\x12\n\nproto_name\x18\x06 \x01(\t\x12\x11\n\tproto_ver\x18\x07 \x01(\t\x12\x11\n\tkeepalive\x18\x08 \x01(\r\"k\n\x14\x43lientConnectRequest\x12*\n\x08\x63onninfo\x18\x01 \x01(\x0b\x32\x18.emqx.exhook.v1.ConnInfo\x12\'\n\x05props\x18\x02 \x03(\x0b\x32\x18.emqx.exhook.v1.Property\"\x80\x01\n\x14\x43lientConnackRequest\x12*\n\x08\x63onninfo\x18\x01 \x01(\x0b\x32\x18.emqx.exhook.v1.ConnInfo\x12\x13\n\x0bresult_code\x18\x02 \x01(\t\x12\'\n\x05props\x18\x03 \x03(\x0b\x32\x18.emqx.exhook.v1.Property\"H\n\x16\x43lientConnectedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\"[\n\x19\x43lientDisconnectedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12\x0e\n\x06reason\x18\x02 \x01(\t\"[\n\x19\x43lientAuthenticateRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12\x0e\n\x06result\x18\x02 \x01(\x08\"\xde\x01\n\x16\x43lientAuthorizeRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12\x45\n\x04type\x18\x02 \x01(\x0e\x32\x37.emqx.exhook.v1.ClientAuthorizeRequest.AuthorizeReqType\x12\r\n\x05topic\x18\x03 \x01(\t\x12\x0e\n\x06result\x18\x04 \x01(\x08\".\n\x10\x41uthorizeReqType\x12\x0b\n\x07PUBLISH\x10\x00\x12\r\n\tSUBSCRIBE\x10\x01\"\xa5\x01\n\x16\x43lientSubscribeRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12\'\n\x05props\x18\x02 \x03(\x0b\x32\x18.emqx.exhook.v1.Property\x12\x32\n\rtopic_filters\x18\x03 \x03(\x0b\x32\x1b.emqx.exhook.v1.TopicFilter\"\xa7\x01\n\x18\x43lientUnsubscribeRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12\'\n\x05props\x18\x02 \x03(\x0b\x32\x18.emqx.exhook.v1.Property\x12\x32\n\rtopic_filters\x18\x03 \x03(\x0b\x32\x1b.emqx.exhook.v1.TopicFilter\"(\n\x0bTopicFilter\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x03qos\x18\x02 \x01(\r\"G\n\x15SessionCreatedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\"\x83\x01\n\x18SessionSubscribedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12\r\n\x05topic\x18\x02 \x01(\t\x12(\n\x07subopts\x18\x03 \x01(\x0b\x32\x17.emqx.exhook.v1.SubOpts\"J\n\x07SubOpts\x12\x0b\n\x03qos\x18\x01 \x01(\r\x12\r\n\x05share\x18\x02 \x01(\t\x12\n\n\x02rh\x18\x03 \x01(\r\x12\x0b\n\x03rap\x18\x04 \x01(\r\x12\n\n\x02nl\x18\x05 \x01(\r\"[\n\x1aSessionUnsubscribedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12\r\n\x05topic\x18\x02 \x01(\t\"G\n\x15SessionResumedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\"I\n\x17SessionDiscardedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\"J\n\x18SessionTakeoveredRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\"Z\n\x18SessionTerminatedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12\x0e\n\x06reason\x18\x02 \x01(\t\"A\n\x15MessagePublishRequest\x12(\n\x07message\x18\x01 \x01(\x0b\x32\x17.emqx.exhook.v1.Message\"s\n\x17MessageDeliveredRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12(\n\x07message\x18\x02 \x01(\x0b\x32\x17.emqx.exhook.v1.Message\"Q\n\x15MessageDroppedRequest\x12(\n\x07message\x18\x01 \x01(\x0b\x32\x17.emqx.exhook.v1.Message\x12\x0e\n\x06reason\x18\x02 \x01(\t\"o\n\x13MessageAckedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v1.ClientInfo\x12(\n\x07message\x18\x02 \x01(\x0b\x32\x17.emqx.exhook.v1.Message\"\xd8\x01\n\x0eValuedResponse\x12:\n\x04type\x18\x01 \x01(\x0e\x32,.emqx.exhook.v1.ValuedResponse.ResponsedType\x12\x15\n\x0b\x62ool_result\x18\x03 \x01(\x08H\x00\x12*\n\x07message\x18\x04 \x01(\x0b\x32\x17.emqx.exhook.v1.MessageH\x00\">\n\rResponsedType\x12\x0c\n\x08\x43ONTINUE\x10\x00\x12\n\n\x06IGNORE\x10\x01\x12\x13\n\x0fSTOP_AND_RETURN\x10\x02\x42\x07\n\x05value2\xc9\x0f\n\x0cHookProvider\x12[\n\x10OnProviderLoaded\x12%.emqx.exhook.v1.ProviderLoadedRequest\x1a\x1e.emqx.exhook.v1.LoadedResponse\"\x00\x12]\n\x12OnProviderUnloaded\x12\'.emqx.exhook.v1.ProviderUnloadedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12W\n\x0fOnClientConnect\x12$.emqx.exhook.v1.ClientConnectRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12W\n\x0fOnClientConnack\x12$.emqx.exhook.v1.ClientConnackRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12[\n\x11OnClientConnected\x12&.emqx.exhook.v1.ClientConnectedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12\x61\n\x14OnClientDisconnected\x12).emqx.exhook.v1.ClientDisconnectedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12\x63\n\x14OnClientAuthenticate\x12).emqx.exhook.v1.ClientAuthenticateRequest\x1a\x1e.emqx.exhook.v1.ValuedResponse\"\x00\x12]\n\x11OnClientAuthorize\x12&.emqx.exhook.v1.ClientAuthorizeRequest\x1a\x1e.emqx.exhook.v1.ValuedResponse\"\x00\x12[\n\x11OnClientSubscribe\x12&.emqx.exhook.v1.ClientSubscribeRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12_\n\x13OnClientUnsubscribe\x12(.emqx.exhook.v1.ClientUnsubscribeRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12Y\n\x10OnSessionCreated\x12%.emqx.exhook.v1.SessionCreatedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12_\n\x13OnSessionSubscribed\x12(.emqx.exhook.v1.SessionSubscribedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12\x63\n\x15OnSessionUnsubscribed\x12*.emqx.exhook.v1.SessionUnsubscribedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12Y\n\x10OnSessionResumed\x12%.emqx.exhook.v1.SessionResumedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12]\n\x12OnSessionDiscarded\x12\'.emqx.exhook.v1.SessionDiscardedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12_\n\x13OnSessionTakeovered\x12(.emqx.exhook.v1.SessionTakeoveredRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12_\n\x13OnSessionTerminated\x12(.emqx.exhook.v1.SessionTerminatedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12[\n\x10OnMessagePublish\x12%.emqx.exhook.v1.MessagePublishRequest\x1a\x1e.emqx.exhook.v1.ValuedResponse\"\x00\x12]\n\x12OnMessageDelivered\x12\'.emqx.exhook.v1.MessageDeliveredRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12Y\n\x10OnMessageDropped\x12%.emqx.exhook.v1.MessageDroppedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x12U\n\x0eOnMessageAcked\x12#.emqx.exhook.v1.MessageAckedRequest\x1a\x1c.emqx.exhook.v1.EmptySuccess\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'exhook_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTYSUCCESS._serialized_start=32
  _EMPTYSUCCESS._serialized_end=46
  _BROKERINFO._serialized_start=48
  _BROKERINFO._serialized_end=129
  _HOOKSPEC._serialized_start=131
  _HOOKSPEC._serialized_end=171
  _PROVIDERLOADEDREQUEST._serialized_start=173
  _PROVIDERLOADEDREQUEST._serialized_end=240
  _LOADEDRESPONSE._serialized_start=242
  _LOADEDRESPONSE._serialized_end=299
  _PROVIDERUNLOADEDREQUEST._serialized_start=301
  _PROVIDERUNLOADEDREQUEST._serialized_end=326
  _CLIENTINFO._serialized_start=329
  _CLIENTINFO._serialized_end=524
  _MESSAGE._serialized_start=526
  _MESSAGE._serialized_end=639
  _PROPERTY._serialized_start=641
  _PROPERTY._serialized_end=680
  _CONNINFO._serialized_start=683
  _CONNINFO._serialized_end=837
  _CLIENTCONNECTREQUEST._serialized_start=839
  _CLIENTCONNECTREQUEST._serialized_end=946
  _CLIENTCONNACKREQUEST._serialized_start=949
  _CLIENTCONNACKREQUEST._serialized_end=1077
  _CLIENTCONNECTEDREQUEST._serialized_start=1079
  _CLIENTCONNECTEDREQUEST._serialized_end=1151
  _CLIENTDISCONNECTEDREQUEST._serialized_start=1153
  _CLIENTDISCONNECTEDREQUEST._serialized_end=1244
  _CLIENTAUTHENTICATEREQUEST._serialized_start=1246
  _CLIENTAUTHENTICATEREQUEST._serialized_end=1337
  _CLIENTAUTHORIZEREQUEST._serialized_start=1340
  _CLIENTAUTHORIZEREQUEST._serialized_end=1562
  _CLIENTAUTHORIZEREQUEST_AUTHORIZEREQTYPE._serialized_start=1516
  _CLIENTAUTHORIZEREQUEST_AUTHORIZEREQTYPE._serialized_end=1562
  _CLIENTSUBSCRIBEREQUEST._serialized_start=1565
  _CLIENTSUBSCRIBEREQUEST._serialized_end=1730
  _CLIENTUNSUBSCRIBEREQUEST._serialized_start=1733
  _CLIENTUNSUBSCRIBEREQUEST._serialized_end=1900
  _TOPICFILTER._serialized_start=1902
  _TOPICFILTER._serialized_end=1942
  _SESSIONCREATEDREQUEST._serialized_start=1944
  _SESSIONCREATEDREQUEST._serialized_end=2015
  _SESSIONSUBSCRIBEDREQUEST._serialized_start=2018
  _SESSIONSUBSCRIBEDREQUEST._serialized_end=2149
  _SUBOPTS._serialized_start=2151
  _SUBOPTS._serialized_end=2225
  _SESSIONUNSUBSCRIBEDREQUEST._serialized_start=2227
  _SESSIONUNSUBSCRIBEDREQUEST._serialized_end=2318
  _SESSIONRESUMEDREQUEST._serialized_start=2320
  _SESSIONRESUMEDREQUEST._serialized_end=2391
  _SESSIONDISCARDEDREQUEST._serialized_start=2393
  _SESSIONDISCARDEDREQUEST._serialized_end=2466
  _SESSIONTAKEOVEREDREQUEST._serialized_start=2468
  _SESSIONTAKEOVEREDREQUEST._serialized_end=2542
  _SESSIONTERMINATEDREQUEST._serialized_start=2544
  _SESSIONTERMINATEDREQUEST._serialized_end=2634
  _MESSAGEPUBLISHREQUEST._serialized_start=2636
  _MESSAGEPUBLISHREQUEST._serialized_end=2701
  _MESSAGEDELIVEREDREQUEST._serialized_start=2703
  _MESSAGEDELIVEREDREQUEST._serialized_end=2818
  _MESSAGEDROPPEDREQUEST._serialized_start=2820
  _MESSAGEDROPPEDREQUEST._serialized_end=2901
  _MESSAGEACKEDREQUEST._serialized_start=2903
  _MESSAGEACKEDREQUEST._serialized_end=3014
  _VALUEDRESPONSE._serialized_start=3017
  _VALUEDRESPONSE._serialized_end=3233
  _VALUEDRESPONSE_RESPONSEDTYPE._serialized_start=3162
  _VALUEDRESPONSE_RESPONSEDTYPE._serialized_end=3224
  _HOOKPROVIDER._serialized_start=3236
  _HOOKPROVIDER._serialized_end=5229
# @@protoc_insertion_point(module_scope)
